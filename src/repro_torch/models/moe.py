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

``moe_block_a2a`` is the reference's explicit all-to-all expert
parallelism over a mesh's "model" axis (``cfg.moe_impl == "a2a"``).

A Switch-style auxiliary load-balance loss is returned for training.

``moe_share_block`` is the MoE layer of a ``layer_pattern`` model
(nemotron-h's relu² experts) and of an ``mla_moe`` one (Kimi-K2's SwiGLU
experts, ``cfg.moe_act``), which holds a share of the router's experts: the
router scores all ``cfg.moe_routed`` experts, the layer computes its own
``cfg.moe_num_experts`` and adds only their part of the result (plus the
shared expert), as one rank of an expert-parallel deployment does without
the exchange. Its dispatch drops nothing and keeps static shapes: the
assignments that land on held experts are sorted by expert into a buffer
of ``T * min(top_k, held)`` rows, the bound a token's held assignments
keep to, and the experts run as two grouped products
(``torch._grouped_mm``) whose offsets stay on the device. The products
leave rows past the last offset undefined: the combine never reads them,
and their gradient is zeroed before it reaches the tokens. Nothing is
read on the host, so the layer captures in a CUDA graph.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from ..parallel.axes import current_ctx, shard
from .common import scaled_init

__all__ = ["a2a_capacities", "init_moe", "init_moe_share", "moe_block", "moe_block_a2a",
           "moe_share_block", "moe_share_shapes", "recomputing", "route", "route_share",
           "slot_maps"]


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
    counts = torch.zeros((b, e), dtype=torch.long, device=flat_e.device).scatter_add(
        1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(sk, device=flat_e.device)[None, :] - torch.gather(starts, 1, se)
    keep = pos < cap
    slot = se * cap + pos                    # valid only where keep
    target = torch.where(keep, slot, dump)   # dropped assignments go to a dump slot
    s2t = torch.zeros((b, dump + 1), dtype=torch.long, device=flat_e.device).scatter(
        1, target, st)
    s2v = torch.zeros((b, dump + 1), dtype=torch.bool, device=flat_e.device).scatter(
        1, target, keep)
    a2s = torch.zeros_like(flat_e).scatter(1, order, torch.where(keep, slot, 0))
    a2v = torch.zeros((b, sk), dtype=torch.bool, device=flat_e.device).scatter(1, order, keep)
    return s2t[:, :dump], s2v[:, :dump], a2s, a2v


def _aux_loss(probs, top_e, e: int) -> torch.Tensor:
    """Switch load-balance loss (eq. 4-6): e * sum(first-choice density *
    mean router probability), the density by scatter (no one-hot)."""
    t = top_e.shape[0] * top_e.shape[1]
    first = top_e[..., 0].reshape(-1)
    density = torch.zeros((e,), dtype=torch.float32, device=first.device).index_add(
        0, first, torch.ones(first.shape, dtype=torch.float32, device=first.device)) / t
    return e * torch.sum(density * probs.reshape(t, e).mean(dim=0))


def moe_block(p, x, cfg):
    """x: (B, S, d) -> (out, aux_loss f32 scalar)."""
    b, s, d = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    cap = max(int(s * k * cfg.capacity_factor / e), 1)
    probs, top_p, top_e = route(p, x, cfg)
    aux = _aux_loss(probs, top_e, e)

    flat_e = top_e.reshape(b, s * k)
    flat_p = top_p.reshape(b, s * k).to(x.dtype)
    s2t, s2v, a2s, a2v = slot_maps(flat_e, e, k, cap)

    # gather tokens into the expert buffers
    buf = torch.gather(x, 1, s2t[..., None].expand(b, e * cap, d))
    buf = torch.where(s2v[..., None], buf, 0).reshape(b, e, cap, d)
    buf = shard(buf, "batch", "experts", None, None)

    # expert FFN over every expert's capacity slots
    h = F.silu(torch.einsum("becd,edf->becf", buf, p["wi_gate"]))
    h = h * torch.einsum("becd,edf->becf", buf, p["wi_up"])
    h = shard(h, "batch", "experts", None, None)
    y = torch.einsum("becf,efd->becd", h, p["wo"]).reshape(b, e * cap, d)

    # combine: k gathers in the original token order, accumulated in x.dtype
    idx = a2s.reshape(b, s, k)
    w = (flat_p * a2v).reshape(b, s, k)
    out = torch.zeros((b, s, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        yj = torch.gather(y, 1, idx[:, :, j, None].expand(b, s, d))
        yj = shard(yj, "batch", "seq_act", None)
        out = out + yj * w[:, :, j, None]
    out = shard(out, "batch", "seq_act", None)

    if cfg.moe_num_shared:
        sp = p["shared"]
        hs = F.silu(x @ sp["wi_gate"]) * (x @ sp["wi_up"])
        out = out + hs @ sp["wo"]
    return out, aux.float()


# ------------------------------------------------------- all-to-all variant
def _rank_within(key, groups: int):
    """Stable sort of ``key`` (values in [0, groups)) and each sorted
    entry's rank within its group: ``(order, sorted key, rank)``."""
    order = torch.sort(key, stable=True).indices
    key_s = key[order]
    counts = torch.zeros((groups,), dtype=torch.long, device=key.device).index_add_(
        0, key_s, torch.ones_like(key_s))
    starts = torch.cumsum(counts, 0) - counts
    return order, key_s, torch.arange(key.shape[0], device=key.device) - starts[key_s]


def _a2a_local(xl, wig, wiu, wo, te, tp, *, e_sh: int, e_l: int, cap_pair: int,
               cap_local: int, exchange, drops: dict | None):
    """One model shard's routed experts: ``xl`` (b_l, s_l, d) this shard's
    tokens, ``te`` / ``tp`` (b_l, s_l, k) their experts and weights,
    ``wig`` / ``wiu`` / ``wo`` this shard's ``e_l`` experts. ``exchange``
    is the all-to-all over the "model" group: (e_sh * n, ...) rows, block
    ``i`` to shard ``i``, block ``j`` of the result from shard ``j``."""
    bl, sl, d = xl.shape
    k = te.shape[-1]
    t = bl * sl * k
    xt = xl.reshape(bl * sl, d)
    se = te.reshape(-1)
    sp = tp.reshape(-1).to(xl.dtype)
    tok = torch.arange(t, device=xl.device) // k
    dst, eid = se // e_l, se % e_l

    # --- send side: rank within the destination shard, capacity-dropped ---
    order, dst_s, pos = _rank_within(dst, e_sh)
    tok_s, eid_s, sp_s = tok[order], eid[order], sp[order]
    keep = pos < cap_pair
    r = e_sh * cap_pair
    slot = torch.where(keep, dst_s * cap_pair + pos, r)
    send_x = xl.new_zeros((r + 1, d))
    send_x[slot] = xt[tok_s]
    send_e = torch.full((r + 1,), -1, dtype=torch.long, device=xl.device)
    send_e[slot] = eid_s

    # --- all-to-all: tokens travel to their experts' shard -------------------
    recv_x = exchange(send_x[:r])
    recv_e = exchange(send_e[:r])

    # --- recv side: group by local expert, capacity-dropped ------------------
    valid = recv_e >= 0
    order2, key_s, pos2 = _rank_within(torch.where(valid, recv_e, e_l), e_l + 1)
    keep2 = (key_s < e_l) & (pos2 < cap_local)
    n_buf = e_l * cap_local
    slot2 = torch.where(keep2, key_s * cap_local + pos2, n_buf)
    buf = xl.new_zeros((n_buf + 1, d))
    buf[slot2] = recv_x[order2]
    buf = buf[:n_buf].reshape(e_l, cap_local, d)
    if drops is not None:
        for name, kept, routed in (("pair", keep, t), ("local", keep2, valid)):
            routed = int(routed.sum()) if torch.is_tensor(routed) else routed
            drops[f"{name}_routed"] = drops.get(f"{name}_routed", 0) + routed
            drops[f"{name}_dropped"] = drops.get(f"{name}_dropped", 0) + routed - int(kept.sum())

    # --- expert FFN ----------------------------------------------------------
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, wig))
    h = h * torch.einsum("ecd,edf->ecf", buf, wiu)
    y = torch.einsum("ecf,efd->ecd", h, wo).reshape(n_buf, d)

    # --- route back (inverse permutations + reverse all-to-all) --------------
    y_sorted = torch.where(keep2[:, None], y[torch.clamp(slot2, max=n_buf - 1)], 0)
    y_recv = xl.new_zeros((r, d))
    y_recv[order2] = y_sorted
    y_send = exchange(y_recv)
    contrib = torch.where(keep[:, None], y_send[torch.clamp(slot, max=r - 1)], 0) * sp_s[:, None]
    out = xl.new_zeros((bl * sl, d)).index_add_(0, tok_s, contrib)
    return out.reshape(bl, sl, d)


def a2a_capacities(cfg, b: int, s: int, e_sh: int, dp_size: int) -> tuple[int, int]:
    """``moe_block_a2a``'s two capacities, letter for letter the
    reference's: ``cap_pair`` rows per (source, destination) shard pair
    (with its ``b // dp_size`` factor) and ``cap_local`` per local expert."""
    cf = cfg.capacity_factor
    cap_pair = max(int(s // e_sh * cfg.moe_top_k * cf / e_sh) * max(b // max(dp_size, 1), 1), 1)
    cap_local = max(int(e_sh * cap_pair * cf / (cfg.moe_num_experts // e_sh)), 1)
    return cap_pair, cap_local


def moe_block_a2a(p, x, cfg, *, drops: dict | None = None):
    """Explicit all-to-all expert parallelism over the mesh's "model" axis
    (the reference's ``moe_block_a2a``, a ``shard_map`` there).

    Tokens are split (batch over the data axes, sequence over "model");
    each model shard routes its own ``(b/dp, s/e_sh)`` block, sends exactly
    the chosen token vectors to the shard that owns their expert with one
    ``all_to_all_single`` over the "model" group, runs its ``e/e_sh``
    experts, and reverses the route for the combine. Two-stage capacity
    dropping, letter for letter the reference's: ``cap_pair`` per
    (source, destination) pair, then ``cap_local`` per local expert; with
    generous capacity the output equals :func:`moe_block`. Routing and the
    aux loss are computed on the global view, the shared experts too.

    Requires an active ``sharding_ctx`` whose mesh has a "model" axis that
    divides both the sequence and the expert count; raises otherwise.

    Two contracts, by the type of ``x``:

    * a plain tensor (eager, on real ranks): ``x`` and the weights are
      replicated on every rank of the mesh; each rank slices its block and
      its experts, and the output blocks are gathered back over the
      "model" and data groups, so ``out`` and ``aux`` come out replicated;
    * a DTensor (the dry run): the blocks are local shards of ``x`` and of
      the expert weights (redistributed to those placements), and ``out``
      is a DTensor sharded (batch over data, sequence over "model"), the
      reference's ``out_specs``.

    ``drops``, when given, accumulates this rank's counts of routed and
    capacity-dropped assignments at each stage (``pair_*``, ``local_*``).
    The all-to-alls go through ``torch.distributed._functional_collectives``
    (NCCL, gloo and the dry run's fake group alike).
    """
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    ctx = current_ctx()
    if ctx is None or "model" not in ctx.mesh.shape:
        raise RuntimeError("moe_block_a2a needs an active sharding ctx with a 'model' axis")
    mesh = ctx.mesh
    dm = mesh.device_mesh
    e_sh = mesh.shape["model"]
    dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
    dp_size = math.prod(mesh.shape[a] for a in dp)
    b, s, d = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    if e % e_sh or s % e_sh:
        raise ValueError(f"'model' axis {e_sh} must divide experts {e} and sequence {s}")
    e_l = e // e_sh
    s_l = s // e_sh
    cap_pair, cap_local = a2a_capacities(cfg, b, s, e_sh, dp_size)

    # routing + aux loss on the global view (router weights are replicated)
    probs, top_p, top_e = route(p, x, cfg)
    aux = _aux_loss(probs, top_e, e)

    axis = {name: i for i, name in enumerate(mesh.shape)}  # funcol's (mesh, dim) groups

    # The autograd collectives have no kernel under inference mode (serving).
    grad = torch.is_grad_enabled()

    def exchange(t):
        a2a = funcol.all_to_all_single_autograd if grad else funcol.all_to_all_single
        return funcol.wait_tensor(a2a(t.contiguous(), None, None, (dm, axis["model"])))

    distributed = isinstance(x, DTensor)
    if distributed:
        blocks = tuple(Shard(0) if n in dp else Shard(1) if n == "model" else Replicate()
                       for n in mesh.shape)
        experts = tuple(Shard(0) if n == "model" else Replicate() for n in mesh.shape)
        local = lambda t, pl: t.redistribute(dm, pl).to_local()  # noqa: E731
        xl, te, tp = (local(t, blocks) for t in (x, top_e, top_p))
        wig, wiu, wo = (local(p[n], experts) for n in ("wi_gate", "wi_up", "wo"))
    else:
        if b % dp_size:
            raise ValueError(f"data axes {dp_size} must divide the batch {b}")
        b_l = b // dp_size
        i_dp = 0
        for a in dp:
            i_dp = i_dp * mesh.shape[a] + mesh.coordinate(a)
        i_m = mesh.coordinate("model")
        rows, cols = slice(i_dp * b_l, (i_dp + 1) * b_l), slice(i_m * s_l, (i_m + 1) * s_l)
        xl, te, tp = (t[rows, cols] for t in (x, top_e, top_p))
        wig, wiu, wo = (p[n][i_m * e_l:(i_m + 1) * e_l] for n in ("wi_gate", "wi_up", "wo"))

    out_l = _a2a_local(xl, wig, wiu, wo, te, tp, e_sh=e_sh, e_l=e_l, cap_pair=cap_pair,
                       cap_local=cap_local, exchange=exchange, drops=drops)

    if distributed:
        out = DTensor.from_local(out_l, dm, blocks, run_check=False)
    else:
        # the blocks gathered back along dim 0 (sequence, then the data axes)
        gather = ((getattr(funcol, "all_gather_single_autograd", None)
                   or funcol.all_gather_tensor_autograd) if grad else funcol.all_gather_tensor)
        out = out_l.transpose(0, 1).contiguous()
        out = funcol.wait_tensor(gather(out, 0, (dm, axis["model"]))).transpose(0, 1)
        for a in reversed(dp):
            out = funcol.wait_tensor(gather(out.contiguous(), 0, (dm, axis[a])))

    if cfg.moe_num_shared:
        sp = p["shared"]
        hs = F.silu(x @ sp["wi_gate"]) * (x @ sp["wi_up"])
        out = out + hs @ sp["wo"]
    return out, aux.float()


# ------------------------------------------------------- the expert share
_RECOMPUTE = threading.local()


@contextlib.contextmanager
def recomputing():
    """The span of an activation checkpoint's recompute (its ``context_fn``):
    a layer's rows counter does not count the layer twice in a step."""
    prev = getattr(_RECOMPUTE, "on", False)
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = prev


def moe_share_shapes(cfg) -> dict:
    """One expert-share layer's parameter shapes: the router over every
    routed expert, the held experts and the shared expert. A sigmoid
    router; non-gated relu² experts (up, down: nemotron-h's) or, with
    ``moe_act="swiglu"``, gated ones (gate, up, down: DeepSeek-V3's)."""
    d, f, e, sf = cfg.d_model, cfg.d_ff, cfg.moe_num_experts, cfg.moe_shared_width
    gated = cfg.moe_act == "swiglu"
    out = {"router": (d, cfg.moe_routed)}
    if gated:
        out["wi_gate"] = (e, d, f)
    out.update(wi_up=(e, d, f), wo=(e, f, d))
    if cfg.moe_num_shared:
        out["shared"] = {"wi_gate": (d, sf)} if gated else {}
        out["shared"].update(wi_up=(d, sf), wo=(sf, d))
    return out


def init_moe_share(gen, cfg, dtype) -> dict:
    """Draws in the order router, wi_up, wo, then the shared expert's
    (``moe_share_shapes``)."""

    def draw(tree):
        return {name: draw(shape) if isinstance(shape, dict) else
                scaled_init(gen, shape, dtype, fan_in=shape[-2])
                for name, shape in tree.items()}

    return draw(moe_share_shapes(cfg))


def route_share(p, x, bias, cfg):
    """x (T, d). The router in f32 over every routed expert: sigmoid
    scores, top-k of score + ``bias`` (the correction bias, which picks the
    experts but weighs nothing), weighted by the chosen scores over ``sum +
    1e-20`` and scaled by ``moe_routed_scale``. Returns ``(top_w (T, k)
    f32, top_e (T, k))``."""
    scores = torch.sigmoid(x.float() @ p["router"].float())
    top_e = torch.topk(scores + bias, cfg.moe_top_k, dim=-1, sorted=True).indices
    top_w = torch.gather(scores, -1, top_e)
    return top_w / (top_w.sum(-1, keepdim=True) + 1e-20) * cfg.moe_routed_scale, top_e


def _experts(x, p, offs=None):
    """``down(relu(up x)^2)``, or ``down(silu(gate x) * up x)`` where ``p``
    holds a gate; with ``offs`` (cumulative row ends) the held experts'
    grouped products on their sorted rows."""
    def mm(a, w):
        return a @ w if offs is None else torch._grouped_mm(a, w, offs=offs)

    if "wi_gate" in p:
        h = F.silu(mm(x, p["wi_gate"])) * mm(x, p["wi_up"])
    else:
        h = torch.relu(mm(x, p["wi_up"])).square()
    return mm(h, p["wo"])


class _TokenRows(torch.autograd.Function):
    """``x[order // k]``: the rows of an assignment buffer. The backward
    puts each row's gradient at its assignment (at most once each) and sums
    a token's ``k`` assignments, so that it adds in a fixed order where a
    scatter-add over tokens would race."""

    @staticmethod
    def forward(ctx, x, order, k):
        ctx.save_for_backward(order)
        ctx.k, ctx.tokens = k, x.shape[0]
        return x.index_select(0, order // k)

    @staticmethod
    def backward(ctx, grad):
        (order,) = ctx.saved_tensors
        per = grad.new_zeros((ctx.tokens * ctx.k, grad.shape[-1]))
        per.index_copy_(0, order, grad)
        return per.view(ctx.tokens, ctx.k, -1).sum(1), None, None


def moe_share_block(p, x, cfg, *, first: int = 0):
    """x: (B, S, d) -> (out, None): the held experts' part of the routed
    result plus the shared expert (the layer of ``moe_share_shapes``). The
    layer holds experts ``first`` to ``first + moe_num_experts - 1`` of the
    router's (``first`` is 0 on the model's path; the tests hold other
    shares). ``p`` holds the parameters
    of ``moe_share_shapes``, the correction bias ``p["bias"]`` (routed,)
    f32 and, on the model's path, ``p["rows"]`` (held,) int64, the rows
    counter, to which a training forward adds each held expert's rows
    (not a checkpoint's recompute, so once a step)."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.moe_top_k, cfg.moe_num_experts
    xt = x.reshape(t, d)
    top_w, top_e = route_share(p, xt, p["bias"], cfg)
    local = top_e - first
    held = (local >= 0) & (local < e)
    key = torch.where(held, local, e).reshape(-1)
    key_s, order = torch.sort(key, stable=True)
    # a token has at most min(k, e) held assignments, all sorted first
    m = t * min(k, e)
    key_s, rows_at = key_s[:m], order[:m]
    valid = (key_s < e)[:, None]
    offs = torch.searchsorted(key_s, torch.arange(1, e + 1, device=x.device), out_int32=True)
    rows = p.get("rows")
    if rows is not None and torch.is_grad_enabled() and not getattr(_RECOMPUTE, "on", False):
        rows.add_(torch.diff(offs, prepend=offs.new_zeros(1)))

    # the mask passes no gradient of the rows past the last offset to x
    buf = torch.where(valid, _TokenRows.apply(xt, rows_at, k), 0)
    y = _experts(buf, p, offs)

    # combine: each assignment's row (held rows lie before the last offset;
    # a zero row m where it is not held), k gathers in token order, weighted
    # and summed in f32
    pos = torch.empty_like(order).scatter_(0, order, torch.arange(t * k, device=x.device))
    idx = torch.where(held.reshape(-1), pos, m).reshape(t, k)
    y = torch.cat([y, y.new_zeros((1, d))])
    w = torch.where(held, top_w, 0.0)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + y.index_select(0, idx[:, j]).float() * w[:, j, None]
    out = out.to(x.dtype)

    if cfg.moe_num_shared:
        out = out + _experts(xt, p["shared"])
    return out.reshape(b, s, d), None
