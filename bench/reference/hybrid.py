"""Plain reference of the hybrid family (zamba2-1.2b), float32.

Token embeddings pass through ``num_layers`` Mamba-2 blocks; after every
``attn_every``-th of them one shared block (causal softmax attention and a
SwiGLU feed-forward, a single set of weights at every site) is applied to
the residual stream. Each Mamba-2 block (arXiv:2405.21060, one group of B
and C shared by all heads), after an RMSNorm:

    z, xBC, dt = x W_in;   xBC = silu(causal depthwise conv(xBC) + b)
    dt = softplus(dt + dt_bias);   A = -exp(A_log)
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_tᵀ;   y_t = C_tᵀ h_t + D x_t
    out = (y * silu(z)) W_out

The scan is computed in the chunked "state space dual" form of the
paper's minimal listing (segment sums of log decays within a chunk, states
passed between chunks), written here from the equations.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import Precision, lm_loss_sums, rms_norm, rope_tables
from .encoder import layer, layer_leaves, logits_of

__all__ = ["layout", "loss_sums", "param_specs"]


def layout(m: dict) -> list:
    """[(kind, count)]: runs of Mamba-2 blocks and the shared block's
    sites, in order, as the checkpoint numbers its ``segments``."""
    kinds = []
    for i in range(m["num_layers"]):
        kinds.append("mamba2")
        if (i + 1) % m["attn_every"] == 0:
            kinds.append("shared_attn")
    runs: list = []
    for k in kinds:
        if runs and runs[-1][0] == k:
            runs[-1][1] += 1
        else:
            runs.append([k, 1])
    return [tuple(r) for r in runs]


def _dims(m: dict) -> tuple:
    di = m["ssm_expand"] * m["d_model"]
    return di, m["ssm_head_dim"], di // m["ssm_head_dim"], m["ssm_state"]


def param_specs(m: dict) -> dict:
    d, v, f = m["d_model"], m["vocab_size"], m["d_ff"]
    hh = m["num_heads"] * m["head_dim"]
    kv = m["num_kv_heads"] * m["head_dim"]
    di, _, heads, n = _dims(m)
    conv = di + 2 * n
    out = {
        "embed": ((v, d), ("normal", 0.02)),
        "final_norm": ((d,), ("zeros",)),
        "lm_head": ((d, v), ("scaled", d)),
        "shared_attn/ln1": ((d,), ("zeros",)),
        "shared_attn/ln2": ((d,), ("zeros",)),
        "shared_attn/attn/wq": ((d, hh), ("scaled", d)),
        "shared_attn/attn/wk": ((d, kv), ("scaled", d)),
        "shared_attn/attn/wv": ((d, kv), ("scaled", d)),
        "shared_attn/attn/wo": ((hh, d), ("scaled", hh)),
        "shared_attn/mlp/wi_gate": ((d, f), ("scaled", d)),
        "shared_attn/mlp/wi_up": ((d, f), ("scaled", d)),
        "shared_attn/mlp/wo": ((f, d), ("scaled", f)),
    }
    for j, (kind, c) in enumerate(layout(m)):
        if kind != "mamba2":
            continue
        s = f"segments/{j}/"
        out.update({
            s + "ln": ((c, d), ("zeros",)),
            s + "mixer/in_proj": ((c, d, 2 * di + 2 * n + heads), ("scaled", d)),
            s + "mixer/conv_w": ((c, m["ssm_conv"], conv), ("normal", 0.1)),
            s + "mixer/conv_b": ((c, conv), ("zeros",)),
            s + "mixer/A_log": ((c, heads), ("a_log",)),
            s + "mixer/dt_bias": ((c, heads), ("zeros",)),
            s + "mixer/D": ((c, heads), ("ones",)),
            s + "mixer/out_proj": ((c, di, d), ("scaled", di)),
        })
    return out


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., T) -> (..., T, T): sum of a[j+1..i] below the diagonal, -inf
    above it."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device))
    return out.masked_fill(~keep, float("-inf"))


def ssd(x, dt, a, b, c, chunk: int, prec: Precision) -> torch.Tensor:
    """The scan of the block's equations. x (B, S, H, P); dt (B, S, H); a
    (H,) negative; b, c (B, S, N). Returns y without the D term."""
    bs, s, h, p = x.shape
    nc = s // chunk
    xd = (x * dt[..., None]).reshape(bs, nc, chunk, h, p)
    la = (dt * a).reshape(bs, nc, chunk, h).permute(0, 3, 1, 2)      # (B, H, C, L)
    bc = b.reshape(bs, nc, chunk, -1)
    cc = c.reshape(bs, nc, chunk, -1)
    cum = torch.cumsum(la, dim=-1)
    decay = torch.exp(_segsum(la))                                   # (B, H, C, L, L)
    cb = prec.einsum("bcln,bcsn->bcls", cc, bc)
    y = prec.einsum("bchls,bcshp->bclhp", cb[:, :, None] * decay.permute(0, 2, 1, 3, 4), xd)
    # each chunk's own contribution to the state at its end
    to_end = torch.exp(cum[..., -1:] - cum)                          # (B, H, C, L)
    states = prec.einsum("bcln,bhcl,bclhp->bchpn", bc, to_end, xd)
    # states entering each chunk, carried across chunk boundaries
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    across = torch.exp(_segsum(F.pad(cum[..., -1], (1, 0))))         # (B, H, C+1, C+1)
    entering = torch.einsum("bhzc,bchpn->bzhpn", across, states)[:, :-1]
    y = y + prec.einsum("bcln,bchpn,bhcl->bclhp", cc, entering, torch.exp(cum))
    return y.reshape(bs, s, h, p)


def mamba_block(p: dict, x, m: dict, prec: Precision):
    """x + Mamba-2(rms_norm(x)) for one layer's leaves ``p``."""
    bs, s, _ = x.shape
    di, hp, heads, n = _dims(m)
    hn = rms_norm(x, p["ln"], m["norm_eps"])
    zx = prec.mm(hn, p["in_proj"])
    z, xbc, dt = zx[..., :di], zx[..., di:2 * di + 2 * n], zx[..., 2 * di + 2 * n:]
    k = p["conv_w"].shape[0]
    xp = F.pad(xbc, (0, 0, k - 1, 0))                                # causal: k-1 zeros first
    conv = sum(xp[:, i:i + s] * p["conv_w"][i] for i in range(k)) + p["conv_b"]
    xbc = F.silu(conv)
    xin, b, c = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    xh = xin.reshape(bs, s, heads, hp)
    chunk = min(m["ssm_chunk"], s)
    y = ssd(xh, dt, a, b, c, chunk, prec) + xh * p["D"][:, None]
    y = y.reshape(bs, s, di) * F.silu(z)
    return x + prec.mm(y, p["out_proj"])


def loss_sums(params: dict, tokens, targets, mask, m: dict, prec: Precision) -> tuple:
    x = prec.q(params["embed"])[tokens.long()]
    sin, cos = rope_tables(x.shape[1], m["head_dim"], m["rope_theta"], x.device)
    shared = layer_leaves(params, "shared_attn/", None)
    for j, (kind, count) in enumerate(layout(m)):
        if kind == "shared_attn":
            for _ in range(count):
                x = checkpoint(layer, shared, x, m, sin, cos, prec, use_reentrant=False)
            continue
        s = f"segments/{j}/"
        for i in range(count):
            p = {"ln": params[s + "ln"][i]}
            p.update({k: params[s + "mixer/" + k][i]
                      for k in ("in_proj", "conv_w", "conv_b", "A_log", "dt_bias", "D",
                                "out_proj")})
            x = checkpoint(mamba_block, p, x, m, prec, use_reentrant=False)
    return lm_loss_sums(logits_of(params, x, m, prec), targets, mask)
