"""Plain reference of the nemotron-h family (NVIDIA-Nemotron-3-Nano-30B-A3B),
float32.

Token embeddings pass through the layers that ``layer_pattern`` names, one
letter a layer, each a pre-norm residual block ``x + mixer(rms_norm(x))``:

- ``M``, Mamba-2 (arXiv:2405.21060) with ``ssm_groups`` groups of B and C,
  head i reading group ``i // (heads / groups)``, and a gated RMSNorm:

      z, xBC, dt = x W_in;   xBC = silu(causal depthwise conv(xBC) + b)
      dt = softplus(dt + dt_bias);   A = -exp(A_log)
      h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_tᵀ;   y_t = C_tᵀ h_t + D x_t
      g = y * silu(z);   out = (rms(g) over each group's channels * (1 + w)) W_out

  the scan in ``hybrid.ssd``'s chunked form, once a group on its heads;
- ``E``, experts: sigmoid scores of an f32 router over all ``moe_routed``
  experts, the top ``moe_top_k`` chosen on score plus the correction bias,
  weighted by their scores over ``sum + 1e-20`` times
  ``moe_routed_scale``; each expert ``down(relu(up x)^2)``; plus one
  shared expert of the same form;
- ``*``, causal GQA softmax attention with no rotary positions.

Then the final RMSNorm and the head. Leaves are named and stacked as the
program's checkpoints name them (runs of one kind stacked on a leading
axis), so that both sides can be given the same weights.

Departures from the published model, as the configuration's file states
them:

- a pipeline's stage 0: the first ``num_layers`` letters of the pattern,
  with the final norm and the head after them (a real stage 0 holds
  neither), so that the loss exists;
- one chip's expert share: the router scores all ``moe_routed`` experts,
  but the layer holds and adds only experts ``0 .. moe_num_experts - 1``,
  the held experts' terms summed by a loop over them, with no capacity;
  what the absent experts would add is left out;
- a vocabulary of ``vocab_size`` rows, the deployment's slice;
- the correction bias held at zero (its update rule is not run) and no
  auxiliary loss; the harness's loss adds a z-loss;
- weights drawn from the seed, the experts' output projections small
  (``param_specs``);
- every norm's gain is ``(1 + w)`` with ``w`` drawn zero, where the
  published weight is ``w`` drawn one: the same function at the start;
- attention applies no rotary embedding, as the published ``nemotron_h``
  modelling code does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import Precision, attention, lm_loss_sums, rms_norm
from .hybrid import ssd

__all__ = ["layout", "loss_sums", "param_specs"]

KINDS = {"M": "mamba2", "E": "moe", "*": "attn"}


def layout(m: dict) -> list:
    """[(kind, count)]: runs of one kind in the first ``num_layers`` letters
    of the pattern, as the checkpoint numbers its ``segments``."""
    runs: list = []
    for c in m["layer_pattern"][:m["num_layers"]]:
        if runs and runs[-1][0] == KINDS[c]:
            runs[-1][1] += 1
        else:
            runs.append([KINDS[c], 1])
    return [tuple(r) for r in runs]


def _mamba_dims(m: dict) -> tuple:
    """(d_inner, head dim, heads, state, groups)."""
    return (m["ssm_heads"] * m["ssm_head_dim"], m["ssm_head_dim"], m["ssm_heads"],
            m["ssm_state"], m["ssm_groups"])


def _routed(m: dict) -> int:
    return m.get("moe_router_experts") or m["moe_num_experts"]


def param_specs(m: dict) -> dict:
    """{leaf path: (shape, init)}; init is ("normal", std), ("scaled",
    fan_in) for a normal of std 1/sqrt(fan_in), ("zeros",), ("ones",) or
    ("a_log",).

    The experts' output projections (routed and shared ``wo``) are drawn
    at Megatron-LM's std for output layers, 0.02 / sqrt(2 x the pattern's
    layers), the rest at 1/sqrt(fan_in). relu² is non-negative, so an
    expert adds the same vector (``wo`` times its mean activation) to
    every token it serves: at 1/sqrt(fan_in) that shared part sends a
    document's tokens to the same few experts (3-6x the mean load by the
    fifth moe layer), which the deployment's correction bias undoes, and
    a token that changes experts between two precisions moves every later
    number. Drawn small, the documents' load is even from the first step,
    and the program's gaps to this reference fall 3-5x while the float8
    control's loss and change gaps fall less."""
    d, v, f = m["d_model"], m["vocab_size"], m["d_ff"]
    wo_std = 0.02 / math.sqrt(2 * len(m["layer_pattern"]))
    hh, kv = m["num_heads"] * m["head_dim"], m["num_kv_heads"] * m["head_dim"]
    di, _, heads, n, g = _mamba_dims(m)
    e, sf = m["moe_num_experts"], m["moe_shared_ff"]
    conv = di + 2 * g * n
    out = {
        "embed": ((v, d), ("normal", 0.02)),
        "final_norm": ((d,), ("zeros",)),
        "lm_head": ((d, v), ("scaled", d)),
    }
    for j, (kind, c) in enumerate(layout(m)):
        s = f"segments/{j}/"
        out[s + "ln"] = ((c, d), ("zeros",))
        if kind == "mamba2":
            out.update({
                s + "mixer/in_proj": ((c, d, 2 * di + 2 * g * n + heads), ("scaled", d)),
                s + "mixer/conv_w": ((c, m["ssm_conv"], conv), ("normal", 0.1)),
                s + "mixer/conv_b": ((c, conv), ("zeros",)),
                s + "mixer/A_log": ((c, heads), ("a_log",)),
                s + "mixer/dt_bias": ((c, heads), ("zeros",)),
                s + "mixer/D": ((c, heads), ("ones",)),
                s + "mixer/norm": ((c, di), ("zeros",)),
                s + "mixer/out_proj": ((c, di, d), ("scaled", di)),
            })
        elif kind == "moe":
            out.update({
                s + "moe/router": ((c, d, _routed(m)), ("scaled", d)),
                s + "moe/wi_up": ((c, e, d, f), ("scaled", d)),
                s + "moe/wo": ((c, e, f, d), ("normal", wo_std)),
                s + "moe/shared/wi_up": ((c, d, sf), ("scaled", d)),
                s + "moe/shared/wo": ((c, sf, d), ("normal", wo_std)),
            })
        else:
            out.update({
                s + "attn/wq": ((c, d, hh), ("scaled", d)),
                s + "attn/wk": ((c, d, kv), ("scaled", d)),
                s + "attn/wv": ((c, d, kv), ("scaled", d)),
                s + "attn/wo": ((c, hh, d), ("scaled", hh)),
            })
    return out


def mamba_block(p: dict, x, m: dict, prec: Precision):
    """x + Mamba-2(rms_norm(x)) for one layer's leaves ``p``."""
    bs, s, _ = x.shape
    di, hp, heads, n, g = _mamba_dims(m)
    hn = rms_norm(x, p["ln"], m["norm_eps"])
    zx = prec.mm(hn, p["in_proj"])
    z, xbc, dt = zx[..., :di], zx[..., di:2 * di + 2 * g * n], zx[..., 2 * di + 2 * g * n:]
    k = p["conv_w"].shape[0]
    xp = F.pad(xbc, (0, 0, k - 1, 0))                                # causal: k-1 zeros first
    xbc = F.silu(sum(xp[:, i:i + s] * p["conv_w"][i] for i in range(k)) + p["conv_b"])
    xin = xbc[..., :di]
    b = xbc[..., di:di + g * n].reshape(bs, s, g, n)
    c = xbc[..., di + g * n:].reshape(bs, s, g, n)
    dt = F.softplus(dt + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    xh = xin.reshape(bs, s, heads, hp)
    chunk = min(m["ssm_chunk"], s)
    hg = heads // g
    y = torch.cat([ssd(xh[:, :, i * hg:(i + 1) * hg], dt[:, :, i * hg:(i + 1) * hg],
                       a[i * hg:(i + 1) * hg], b[:, :, i], c[:, :, i], chunk, prec)
                   for i in range(g)], dim=2)
    y = (y + xh * p["D"][:, None]).reshape(bs, s, di)
    gated = (y * F.silu(z)).reshape(bs, s, g, di // g)
    gated = gated * torch.rsqrt(torch.mean(gated * gated, dim=-1, keepdim=True) + m["norm_eps"])
    gated = gated.reshape(bs, s, di) * (1.0 + p["norm"])
    return x + prec.mm(gated, p["out_proj"])


def _relu2(x, up, down, prec: Precision):
    return prec.mm(torch.relu(prec.mm(x, up)) ** 2, down)


def moe_block(p: dict, x, m: dict, prec: Precision, first: int = 0):
    """x + the held experts' part of the routed experts + the shared
    expert, for one layer's leaves ``p``; the layer holds experts
    ``first .. first + moe_num_experts - 1`` of the router's. The
    correction bias is ``p["bias"]`` where given, else zero (a run's)."""
    bs, s, d = x.shape
    hn = rms_norm(x, p["ln"], m["norm_eps"]).reshape(bs * s, d)
    scores = torch.sigmoid(prec.mm(hn, p["router"]))
    bias = p.get("bias", torch.zeros(scores.shape[-1], device=x.device))
    top = torch.topk(scores + bias, m["moe_top_k"], dim=-1).indices
    w = torch.gather(scores, -1, top)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * m["moe_routed_scale"]
    out = _relu2(hn, p["shared_wi_up"], p["shared_wo"], prec)
    for e in range(m["moe_num_experts"]):
        chosen = top == first + e                                     # (T, k)
        rows = chosen.any(-1).nonzero()[:, 0]
        if rows.numel():
            we = (w * chosen).sum(-1)[rows]
            y = _relu2(hn[rows], p["wi_up"][e], p["wo"][e], prec) * we[:, None]
            out = out.index_add(0, rows, y)
    return x + out.reshape(bs, s, d)


def attn_block(p: dict, x, m: dict, prec: Precision):
    """x + causal GQA attention(rms_norm(x)), no rotary positions."""
    b, s, _ = x.shape
    hd, h, kvh = m["head_dim"], m["num_heads"], m["num_kv_heads"]
    hn = rms_norm(x, p["ln"], m["norm_eps"])
    q = prec.mm(hn, p["wq"]).reshape(b, s, h, hd)
    k = torch.repeat_interleave(prec.mm(hn, p["wk"]).reshape(b, s, kvh, hd), h // kvh, dim=2)
    v = torch.repeat_interleave(prec.mm(hn, p["wv"]).reshape(b, s, kvh, hd), h // kvh, dim=2)
    o = attention(q, k, v, causal=True, window=0, prec=prec)
    return x + prec.mm(o.reshape(b, s, h * hd), p["wo"])


_LEAVES = {
    "mamba2": (mamba_block, {k: "mixer/" + k for k in (
        "in_proj", "conv_w", "conv_b", "A_log", "dt_bias", "D", "norm", "out_proj")}),
    "moe": (moe_block, {"router": "moe/router", "wi_up": "moe/wi_up", "wo": "moe/wo",
                        "shared_wi_up": "moe/shared/wi_up", "shared_wo": "moe/shared/wo"}),
    "attn": (attn_block, {k: "attn/" + k for k in ("wq", "wk", "wv", "wo")}),
}


def layer_leaves(params: dict, j: int, kind: str, i: int) -> dict:
    """Layer ``i`` of segment ``j``'s leaves, by the names its block reads."""
    s = f"segments/{j}/"
    out = {"ln": params[s + "ln"][i]}
    out.update({k: params[s + v][i] for k, v in _LEAVES[kind][1].items()})
    return out


def loss_sums(params: dict, tokens, targets, mask, m: dict, prec: Precision) -> tuple:
    """(masked cross-entropy sum, masked logsumexp² sum) over these rows,
    each layer recomputed in the backward pass."""
    x = prec.q(params["embed"])[tokens.long()]
    for j, (kind, count) in enumerate(layout(m)):
        for i in range(count):
            x = checkpoint(_LEAVES[kind][0], layer_leaves(params, j, kind, i), x, m, prec,
                           use_reentrant=False)
    logits = prec.mm(rms_norm(x, params["final_norm"], m["norm_eps"]), params["lm_head"])
    return lm_loss_sums(logits, targets, mask)
