"""Plain reference of Kimi-K2 (Kimi-K2-Instruct, DeepSeek-V3's layout), float32.

Token embeddings pass through ``num_layers`` pre-norm layers, each

    x = x + MLA(rms_norm(x));   x = x + FFN(rms_norm(x))

with multi-head latent attention (DeepSeek-V2, arXiv:2405.04434):

    q = W_qb rms(W_qa x), per head [q_nope (qk_nope_head_dim), q_pe (qk_rope_head_dim)]
    [c, k_pe] = W_kva x;   kv = W_kvb rms(c), per head [k_nope, v (v_head_dim)]
    q_pe, k_pe rotated by YaRN's frequencies (arXiv:2309.00071); k_pe one for all heads
    o = softmax(scale [q_nope, q_pe] [k_nope, k_pe]^T, causal) v;   out = W_o o

where YaRN (``rope_scaling``, HF's keys) keeps ``theta^(-2i/dim)`` below
the correction range of ``beta_fast`` / ``beta_slow`` rotations over
``original_max_position_embeddings`` positions, divides it by ``factor``
above, with a linear ramp between, and scale is ``(Dqk)^-0.5`` times
``(0.1 mscale_all_dim ln(factor) + 1)^2``. The FFN of the first
``moe_first_dense`` layers is a SwiGLU of ``moe_dense_ff``; the others
score every routed expert with a sigmoid of an f32 router, choose the top
``moe_top_k`` on score plus the correction bias, weigh them by their
scores over ``sum + 1e-20`` times ``moe_routed_scale``, and add a SwiGLU
expert of ``d_ff`` for each, plus a shared SwiGLU expert of
``moe_shared_ff``. Then the final RMSNorm and the head. Attention is
computed a batch row and a group of heads at a time, each group
recomputed in the backward pass, so that the (S, S) logits of one group
are all that is held. Leaves are named and stacked as the program's
checkpoints name them, so that both sides can be given the same weights.

Departures from the published model, as the configuration's file states
them:

- a pipeline's stage 0: the first ``num_layers`` layers, with the final
  norm and the head after them (a real stage 0 holds neither), so that the
  loss exists;
- one chip's expert share: the router scores all ``moe_router_experts``
  experts, but the layer holds and adds only experts ``0 .. moe_num_experts
  - 1``, the held experts' terms summed by a loop over them, with no
  capacity; what the absent experts would add is left out;
- a vocabulary of ``vocab_size`` rows, the deployment's slice;
- the correction bias held at zero (its update rule is not run) and no
  auxiliary loss; the harness's loss adds a z-loss;
- the rotary layout is half-split (the first and second halves of the 64
  rotary columns rotated as pairs), where DeepSeek-V3's code first
  de-interleaves pairs (2i, 2i + 1): a fixed permutation of W_qb's and
  W_kva's rotary columns, the same function of other weights;
- every norm's gain is ``(1 + w)`` with ``w`` drawn zero, where the
  published weight is ``w`` drawn one: the same function at the start;
- weights drawn from the seed (``param_specs``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import Precision, apply_rope, lm_loss_sums, rms_norm

__all__ = ["experts", "layout", "loss_sums", "mla", "param_specs", "softmax_scale", "yarn_tables"]

#: Heads of one attention block (with a batch row): the f32 logits of 8
#: heads at S = 4096 are 537 MB.
HEAD_GROUP = 8


def layout(m: dict) -> list:
    """[(kind, count)]: the leading dense layers, then the expert layers, as
    the checkpoint numbers its ``segments``."""
    dense = m["moe_first_dense"]
    return [(k, c) for k, c in (("mla_dense", dense), ("mla_moe", m["num_layers"] - dense))
            if c]


def _routed(m: dict) -> int:
    return m.get("moe_router_experts") or m["moe_num_experts"]


def param_specs(m: dict) -> dict:
    """{leaf path: (shape, init)}; init is ("normal", std), ("scaled",
    fan_in) for a normal of std 1/sqrt(fan_in), or ("zeros",). Every
    projection at 1/sqrt(fan_in), the embedding at 0.02, norm gains zero."""
    d, v, h = m["d_model"], m["vocab_size"], m["num_heads"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    ql, kl = m["q_lora_rank"], m["kv_lora_rank"]
    f, e, sf = m["d_ff"], m["moe_num_experts"], m["moe_shared_ff"]
    out = {
        "embed": ((v, d), ("normal", 0.02)),
        "final_norm": ((d,), ("zeros",)),
        "lm_head": ((d, v), ("scaled", d)),
    }
    for j, (kind, c) in enumerate(layout(m)):
        s = f"segments/{j}/"
        out.update({
            s + "ln1": ((c, d), ("zeros",)),
            s + "ln2": ((c, d), ("zeros",)),
            s + "attn/wq_a": ((c, d, ql), ("scaled", d)),
            s + "attn/q_norm": ((c, ql), ("zeros",)),
            s + "attn/wq_b": ((c, ql, h * (dn + dr)), ("scaled", ql)),
            s + "attn/wkv_a": ((c, d, kl + dr), ("scaled", d)),
            s + "attn/kv_norm": ((c, kl), ("zeros",)),
            s + "attn/wkv_b": ((c, kl, h * (dn + dv)), ("scaled", kl)),
            s + "attn/wo": ((c, h * dv, d), ("scaled", h * dv)),
        })
        if kind == "mla_dense":
            fd = m["moe_dense_ff"]
            out.update({
                s + "mlp/wi_gate": ((c, d, fd), ("scaled", d)),
                s + "mlp/wi_up": ((c, d, fd), ("scaled", d)),
                s + "mlp/wo": ((c, fd, d), ("scaled", fd)),
            })
        else:
            out.update({
                s + "moe/router": ((c, d, _routed(m)), ("scaled", d)),
                s + "moe/wi_gate": ((c, e, d, f), ("scaled", d)),
                s + "moe/wi_up": ((c, e, d, f), ("scaled", d)),
                s + "moe/wo": ((c, e, f, d), ("scaled", f)),
                s + "moe/shared/wi_gate": ((c, d, sf), ("scaled", d)),
                s + "moe/shared/wi_up": ((c, d, sf), ("scaled", d)),
                s + "moe/shared/wo": ((c, sf, d), ("scaled", sf)),
            })
    return out


def _mscale(factor: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_tables(seq_len: int, m: dict, device) -> tuple:
    """(sin, cos) of the rotary part, each (S, qk_rope_head_dim // 2) f32;
    ``m["rope_scaling"]`` is HF's YaRN dict, or None."""
    dim, base = m["qk_rope_head_dim"], float(m["rope_theta"])
    yarn = m.get("rope_scaling")
    i = torch.arange(dim // 2, dtype=torch.float64)
    freq = 1.0 / base ** (2 * i / dim)
    if yarn:
        def corr(rot):
            return (dim * math.log(yarn["original_max_position_embeddings"] / (rot * 2 * math.pi))
                    / (2 * math.log(base)))

        low = max(math.floor(corr(yarn["beta_fast"])), 0)
        high = min(math.ceil(corr(yarn["beta_slow"])), dim - 1)
        ramp = torch.clamp((i - low) / max(high - low, 1e-3), 0.0, 1.0)
        freq = freq / yarn["factor"] * ramp + freq * (1.0 - ramp)
    pos = torch.arange(seq_len, dtype=torch.float64)
    ang = (pos[:, None] * freq.to(torch.float32).to(torch.float64)[None, :]).to(torch.float32)
    sin, cos = torch.sin(ang), torch.cos(ang)
    if yarn:
        ratio = (_mscale(yarn["factor"], yarn["mscale"])
                 / _mscale(yarn["factor"], yarn["mscale_all_dim"]))
        sin, cos = sin * ratio, cos * ratio
    return sin.to(device), cos.to(device)


def softmax_scale(m: dict) -> float:
    scale = (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5
    yarn = m.get("rope_scaling")
    if yarn and yarn["mscale_all_dim"]:
        scale *= _mscale(yarn["factor"], yarn["mscale_all_dim"]) ** 2
    return scale


def _attend(q, k, v, scale: float, causal: bool, prec: Precision):
    """One block: q / k (S, G, Dqk), v (S, G, Dv) -> (S, G, Dv)."""
    s = q.shape[0]
    logits = prec.einsum("qhd,khd->hqk", q, k) * scale
    if causal:
        allowed = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~allowed, float("-inf"))
    return prec.einsum("hqk,khd->qhd", torch.softmax(logits, dim=-1), v)


def attention(q, k, v, scale: float, causal: bool, prec: Precision):
    """q / k (B, S, H, Dqk), v (B, S, H, Dv) -> (B, S, H, Dv), a batch row
    and HEAD_GROUP heads at a time."""
    rows = []
    for b in range(q.shape[0]):
        groups = [checkpoint(_attend, q[b, :, g:g + HEAD_GROUP], k[b, :, g:g + HEAD_GROUP],
                             v[b, :, g:g + HEAD_GROUP], scale, causal, prec,
                             use_reentrant=False)
                  for g in range(0, q.shape[2], HEAD_GROUP)]
        rows.append(torch.cat(groups, dim=1))
    return torch.stack(rows)


def mla(p: dict, hn, m: dict, prec: Precision):
    """MLA of normed rows ``hn`` (B, S, d) for one layer's attention leaves
    ``p``."""
    b, s, _ = hn.shape
    h, dn, dr, dv = m["num_heads"], m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    eps, kl = m["norm_eps"], m["kv_lora_rank"]
    q = prec.mm(rms_norm(prec.mm(hn, p["wq_a"]), p["q_norm"], eps), p["wq_b"])
    q = q.reshape(b, s, h, dn + dr)
    ckv = prec.mm(hn, p["wkv_a"])
    kv = prec.mm(rms_norm(ckv[..., :kl], p["kv_norm"], eps), p["wkv_b"]).reshape(b, s, h, dn + dv)
    sin, cos = yarn_tables(s, m, hn.device)
    q_pe = apply_rope(q[..., dn:], sin, cos)
    k_pe = apply_rope(ckv[..., kl:][:, :, None, :], sin, cos).expand(b, s, h, dr)
    q = torch.cat([q[..., :dn], q_pe], dim=-1)
    k = torch.cat([kv[..., :dn], k_pe], dim=-1)
    o = attention(q, k, kv[..., dn:], softmax_scale(m), m.get("causal", True), prec)
    return prec.mm(o.reshape(b, s, h * dv), p["wo"])


def swiglu(p: dict, x, prec: Precision):
    return prec.mm(F.silu(prec.mm(x, p["wi_gate"])) * prec.mm(x, p["wi_up"]), p["wo"])


def experts(p: dict, hn, m: dict, prec: Precision, first: int = 0):
    """The held experts' part of the routed result plus the shared expert,
    on normed rows ``hn`` (T, d), for one layer's ``moe`` leaves ``p``; the
    layer holds experts ``first .. first + moe_num_experts - 1`` of the
    router's. The correction bias is ``p["bias"]`` where given, else zero
    (a run's)."""
    scores = torch.sigmoid(prec.mm(hn, p["router"]))
    bias = p.get("bias", torch.zeros(scores.shape[-1], device=hn.device))
    top = torch.topk(scores + bias, m["moe_top_k"], dim=-1).indices
    w = torch.gather(scores, -1, top)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * m["moe_routed_scale"]
    out = swiglu(p["shared"], hn, prec)
    for e in range(m["moe_num_experts"]):
        chosen = top == first + e                                     # (T, k)
        rows = chosen.any(-1).nonzero()[:, 0]
        if rows.numel():
            we = (w * chosen).sum(-1)[rows]
            held = {k: p[k][e] for k in ("wi_gate", "wi_up", "wo")}
            out = out.index_add(0, rows, swiglu(held, hn[rows], prec) * we[:, None])
    return out


def layer(p: dict, x, m: dict, prec: Precision):
    """One layer, x (B, S, d): MLA, then the dense SwiGLU (``p["mlp"]``) or
    the experts (``p["moe"]``), each a pre-norm residual."""
    eps = m["norm_eps"]
    x = x + mla(p["attn"], rms_norm(x, p["ln1"], eps), m, prec)
    hn = rms_norm(x, p["ln2"], eps)
    if "mlp" in p:
        return x + swiglu(p["mlp"], hn, prec)
    b, s, d = x.shape
    return x + experts(p["moe"], hn.reshape(b * s, d), m, prec).reshape(b, s, d)


def layer_leaves(params: dict, j: int, i: int) -> dict:
    """Layer ``i`` of segment ``j``'s leaves as a tree: ``{"ln1", "ln2",
    "attn": {...}, "mlp" or "moe": {...}}``."""
    prefix, out = f"segments/{j}/", {}
    for path, t in params.items():
        if path.startswith(prefix):
            *parents, name = path[len(prefix):].split("/")
            node = out
            for k in parents:
                node = node.setdefault(k, {})
            node[name] = t[i]
    return out


def loss_sums(params: dict, tokens, targets, mask, m: dict, prec: Precision) -> tuple:
    """(masked cross-entropy sum, masked logsumexp² sum) over these rows,
    each layer recomputed in the backward pass."""
    x = prec.q(params["embed"])[tokens.long()]
    for j, (_, count) in enumerate(layout(m)):
        for i in range(count):
            x = checkpoint(layer, layer_leaves(params, j, i), x, m, prec, use_reentrant=False)
    logits = prec.mm(rms_norm(x, params["final_norm"], m["norm_eps"]), params["lm_head"])
    return lm_loss_sums(logits, targets, mask)
