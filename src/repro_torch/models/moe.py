"""Fine-grained MoE: shared + routed experts, top-k token-choice routing
(``repro/models/moe.py``).

DeepSeekMoE [arXiv:2401.06066] (deepseek-moe-16b: 2 shared + 64 routed,
top-6) and the same structure at Kimi-K2 scale (384 routed, top-8). Op
for op the reference's sort-based dispatch with capacity dropping, grouped
by batch row: each row's ``s*k`` assignments are stable-sorted by expert,
an assignment's rank within its expert decides whether it fits the
``cap = max(int(s*k*capacity_factor/e), 1)`` slots, so a row's *later*
tokens are the ones dropped. The four integer routing maps are built for
every row at once with batched ``scatter_`` / ``gather`` (the reference
``vmap``s a per-row function). The expert FFN multiplies the whole
(B, E, cap, d) buffer, so one decode token (cap 1) reads every expert's
weights, as in the reference.

The reference's ``moe_block_a2a`` (``shard_map`` all-to-all over a mesh's
"model" axis) has no single-card counterpart; ``Model`` refuses
``moe_impl="a2a"``.

A Switch-style auxiliary load-balance loss is returned for training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import scaled_init

__all__ = ["init_moe", "moe_block", "route", "slot_maps"]


def init_moe(gen, cfg, dtype) -> dict:
    """Draws in the reference's order: router, wi_gate, wi_up, wo, then the
    shared experts' three matrices."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_num_experts
    p = {
        "router": scaled_init(gen, (d, e), dtype),
        "wi_gate": scaled_init(gen, (e, d, f), dtype, fan_in=d),
        "wi_up": scaled_init(gen, (e, d, f), dtype, fan_in=d),
        "wo": scaled_init(gen, (e, f, d), dtype, fan_in=f),
    }
    if cfg.moe_num_shared:
        sf = f * cfg.moe_num_shared
        p["shared"] = {
            "wi_gate": scaled_init(gen, (d, sf), dtype),
            "wi_up": scaled_init(gen, (d, sf), dtype),
            "wo": scaled_init(gen, (sf, d), dtype, fan_in=sf),
        }
    return p


def route(p, x, cfg):
    """Router in ``x.dtype``, then f32: softmax, top-k (sorted descending,
    the lower index first on a tie, as ``lax.top_k``), renormalised by
    ``max(sum, 1e-9)``. Returns ``(probs (b,s,e), top_p, top_e (b,s,k))``."""
    logits = (x @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.moe_top_k, dim=-1, sorted=True)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def slot_maps(flat_e, num_experts: int, top_k: int, cap: int):
    """Every row's routing maps at once. ``flat_e`` (b, s*k) expert ids.

    Returns ``s2t`` (b, e*cap) the token in each expert slot, ``s2v`` its
    validity, ``a2s`` (b, s*k) each assignment's slot (0 where dropped)
    and ``a2v`` whether it was kept, equal to the reference's per-row
    ``slot_maps`` (int64 and bool here, int32 and bool there).
    """
    b, sk = flat_e.shape
    e, dump = num_experts, num_experts * cap
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    se = torch.gather(flat_e, 1, order)
    st = order // top_k                      # token of each sorted assignment
    counts = torch.zeros((b, e), dtype=torch.long, device=flat_e.device)
    counts.scatter_add_(1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(sk, device=flat_e.device)[None, :] - torch.gather(starts, 1, se)
    keep = pos < cap
    slot = se * cap + pos                    # valid only where keep
    target = torch.where(keep, slot, dump)   # dropped assignments go to a dump slot
    s2t = torch.zeros((b, dump + 1), dtype=torch.long, device=flat_e.device)
    s2t.scatter_(1, target, st)
    s2v = torch.zeros((b, dump + 1), dtype=torch.bool, device=flat_e.device)
    s2v.scatter_(1, target, keep)
    a2s = torch.zeros_like(flat_e).scatter_(1, order, torch.where(keep, slot, 0))
    a2v = torch.zeros((b, sk), dtype=torch.bool, device=flat_e.device).scatter_(1, order, keep)
    return s2t[:, :dump], s2v[:, :dump], a2s, a2v


def moe_block(p, x, cfg):
    """x: (B, S, d) -> (out, aux_loss f32 scalar)."""
    b, s, d = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    cap = max(int(s * k * cfg.capacity_factor / e), 1)
    probs, top_p, top_e = route(p, x, cfg)

    # aux load-balance loss (Switch eq. 4-6): density of the first choice
    t = b * s
    density = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, top_e[..., 0].reshape(-1), torch.ones((t,), dtype=torch.float32, device=x.device)
    ) / t
    router_mean = probs.reshape(t, e).mean(dim=0)
    aux = e * torch.sum(density * router_mean)

    flat_e = top_e.reshape(b, s * k)
    flat_p = top_p.reshape(b, s * k).to(x.dtype)
    s2t, s2v, a2s, a2v = slot_maps(flat_e, e, k, cap)

    # gather tokens into the expert buffers
    buf = torch.gather(x, 1, s2t[..., None].expand(b, e * cap, d))
    buf = torch.where(s2v[..., None], buf, 0).reshape(b, e, cap, d)

    # expert FFN over every expert's capacity slots
    h = F.silu(torch.einsum("becd,edf->becf", buf, p["wi_gate"]))
    h = h * torch.einsum("becd,edf->becf", buf, p["wi_up"])
    y = torch.einsum("becf,efd->becd", h, p["wo"]).reshape(b, e * cap, d)

    # combine: k gathers in the original token order, accumulated in x.dtype
    idx = a2s.reshape(b, s, k)
    w = (flat_p * a2v).reshape(b, s, k)
    out = torch.zeros((b, s, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        yj = torch.gather(y, 1, idx[:, :, j, None].expand(b, s, d))
        out = out + yj * w[:, :, j, None]

    if cfg.moe_num_shared:
        sp = p["shared"]
        hs = F.silu(x @ sp["wi_gate"]) * (x @ sp["wi_up"])
        out = out + hs @ sp["wo"]
    return out, aux.float()
