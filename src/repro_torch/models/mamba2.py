"""Mamba-2 (SSD) block [arXiv:2405.21060] (``repro/models/mamba2.py``).

State-space duality form: per head with state size n,
    h_t = exp(A·dt_t) · h_{t-1} + dt_t · B_t x_tᵀ        (n × p state)
    y_t = C_tᵀ h_t + D · x_t
with scalar A < 0 per head, data-dependent dt, and one B and C shared by
every head (n_groups = 1, as in zamba2-1.2b). The projections, the conv,
prefill and decode are op for op the reference's; the training scan is
not (below).

The scan takes one of two routes, as attention does (``attention.py``):
prefill (``want_cache``, no gradient) runs it in the ``ssd_scan`` kernel's
model-layout entry, which reads x, B and C in place in the conv output and
returns the final state; training runs :func:`_ssd_chunked`, which autograd
differentiates. Where the reference scans chunk by chunk and contracts
(q, k, h, p) in one einsum, which torch evaluates through a (b, q, h, p, k)
product, :func:`_ssd_chunked` takes every chunk at once as batched f32
GEMMs and holds no tensor with both p and a second sequence axis; the
tests hold it to the reference's outputs, final state and gradients.
Decode is the O(1) recurrence in plain PyTorch (the reference has no
kernel for it), and updates the SSM and conv states in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan.ops import ssd_scan_heads
from ..parallel.axes import per_shard, shard
from .common import normal_init, scaled_init

__all__ = ["init_mamba2", "mamba2_block", "mamba2_decode", "mamba2_state_shape"]


def _dims(cfg):
    di = cfg.d_inner
    p = cfg.ssm_head_dim
    heads = di // p
    n = cfg.ssm_state
    return di, p, heads, n


def init_mamba2(gen, cfg, dtype) -> dict:
    """Draws in the reference's order: in_proj, conv_w, out_proj."""
    d = cfg.d_model
    di, p, heads, n = _dims(cfg)
    conv_dim = di + 2 * n  # conv over x, B, C
    in_proj = scaled_init(gen, (d, 2 * di + 2 * n + heads), dtype)
    conv_w = normal_init(gen, (cfg.ssm_conv, conv_dim), dtype, 0.1)
    out_proj = scaled_init(gen, (di, d), dtype, fan_in=di)
    device = gen.device
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, heads, device=device)).to(dtype),
        "dt_bias": torch.zeros((heads,), dtype=dtype, device=device),
        "D": torch.ones((heads,), dtype=dtype, device=device),
        "out_proj": out_proj,
    }


def mamba2_state_shape(cfg, batch) -> dict:
    di, p, heads, n = _dims(cfg)
    return {
        "ssm": (batch, heads, p, n),
        "conv": (batch, cfg.ssm_conv - 1, di + 2 * n),
    }


def _split_proj(z_all, cfg):
    di, p, heads, n = _dims(cfg)
    z, rest = z_all[..., :di], z_all[..., di:]
    xbc, dt = rest[..., : di + 2 * n], rest[..., di + 2 * n :]
    return z, xbc, dt


def _causal_conv(xbc, w, b, init_state=None):
    """Depthwise causal conv1d; returns (out, trailing context)."""
    k = w.shape[0]
    if init_state is None:
        pad = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[-1]))
    else:
        pad = init_state
    xp = torch.cat([pad, xbc], dim=1)  # (B, S+k-1, C)
    out = sum(xp[:, i : i + xbc.shape[1]] * w[i] for i in range(k)) + b
    return F.silu(out), xp[:, -(k - 1) :] if k > 1 else pad[:, :0]


def _ssd_chunked(xh, dt, A, B, C, chunk, ssm_init=None):
    """Chunked SSD scan, the training route: batched GEMMs over every chunk.

    xh: (b, s, h, p) head inputs; dt: (b, s, h) positive step sizes;
    A: (h,) negative decay rates; B, C: (b, s, n).
    Returns (y (b,s,h,p), final_state (b,h,p,n)), all f32.

    With l = chunk and c = s // l chunks, cum the inclusive log-decay within
    each chunk and x' = dt ∘ x:

    * intra-chunk: y = (L ∘ C Bᵀ) @ x' over (b, c, h), with
      L[q, k] = exp(cum_q - cum_k) for q >= k, masked before the exp;
    * chunk states: (x' ∘ exp(cum_end - cum))ᵀ @ B, (b, c, h, p, n);
    * across chunks: the (c+1)² matrix of chunk-total decays carries
      ``ssm_init`` and the chunk states into the state entering each chunk,
      the last row being the final state;
    * inter-chunk: y += (C @ enteringᵀ) ∘ exp(cum).

    The largest tensor is (b, c, h, l, l), b·s·h·l elements: none holds both
    p and a second sequence axis, where a contraction over (q, k, h, p)
    would form a (b, q, h, p, k) product. Shapes depend only on
    (b, s, h, p, n, chunk) and nothing is read on the host, so the route
    captures in a CUDA graph.
    """
    b, s, h, p = xh.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the SSD chunk {chunk}")
    nc = s // chunk
    dtc = dt.reshape(b, nc, chunk, h)
    xdt = xh.reshape(b, nc, chunk, h, p) * dtc[..., None]      # (b, c, l, h, p)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)
    cum = torch.cumsum(dtc * A, dim=2)  # (b, c, l, h) inclusive log-decay (negative)

    # intra: L[q,k] = exp(cum_q - cum_k), q >= k (decay over k+1..q)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    ch = cum.transpose(2, 3).contiguous()[..., None]           # (b, c, h, l, 1)
    # (-ch) on the small operand: the backward then negates no (q, k) tensor
    decay = torch.exp(torch.where(mask, ch + (-ch).transpose(3, 4), -torch.inf))
    cb = Cc @ Bc.transpose(2, 3)                               # (b, c, q, k), shared by heads
    y = (decay * cb[:, :, None]) @ xdt.transpose(2, 3)         # (b, c, h, q, p)

    # chunk states: sum_k exp(cum_end - cum_k) dt_k x_k B_kᵀ
    to_end = torch.exp(cum[:, :, -1:] - cum)                   # (b, c, l, h)
    st = (xdt * to_end[..., None]).reshape(b, nc, chunk, h * p).transpose(2, 3) @ Bc

    # across: entering[z] = sum_{j<=z} exp(total_j + ... + total_{z-1}) S_j,
    # S_0 the initial state, S_{j+1} chunk j's state
    init = (xh.new_zeros((b, 1, h * p, n)) if ssm_init is None
            else ssm_init.float().reshape(b, 1, h * p, n))
    states = torch.cat([init, st], dim=1).reshape(b, nc + 1, h, p * n).transpose(1, 2)
    tot = F.pad(cum[:, :, -1].transpose(1, 2), (1, 0))         # (b, h, c+1), tot[0] = 0
    ones = torch.ones((nc + 1, nc + 1), dtype=torch.bool, device=xh.device)
    # seg[z, j] = tot[j+1] + ... + tot[z], summed in order (no cumsum differences)
    seg = torch.cumsum(torch.where(torch.tril(ones, -1), tot[..., None], 0.0), dim=2)
    across = torch.exp(torch.where(torch.tril(ones), seg, -torch.inf))  # (b, h, z, j)
    entering = (across @ states).reshape(b, h, nc + 1, p, n)

    # inter: the state entering each chunk, decayed to each position
    ent = entering[:, :, :nc].transpose(1, 2).reshape(b, nc, h * p, n)
    y = (Cc @ ent.transpose(2, 3)).reshape(b, nc, chunk, h, p) * torch.exp(cum)[..., None] \
        + y.transpose(2, 3)
    return y.reshape(b, s, h, p), entering[:, :, nc]


def mamba2_block(p_, x, cfg, *, init_state=None, chunk=None, want_cache=False):
    """x: (B,S,d) -> (y, {"ssm","conv"} final state).

    ``want_cache`` (prefill: no gradient) runs the scan in the ``ssd_scan``
    kernel; otherwise :func:`_ssd_chunked` runs. Either way S must be at
    most the chunk or a multiple of it, the reference's rule.
    """
    chunk = chunk or cfg.ssm_chunk
    b, s, d = x.shape
    di, ph, heads, n = _dims(cfg)
    z_all = x @ p_["in_proj"]
    z, xbc, dt = _split_proj(z_all, cfg)
    conv_init = None if init_state is None else init_state["conv"]
    xbc, conv_state = _causal_conv(xbc, p_["conv_w"], p_["conv_b"], conv_init)
    xin, B, C = xbc[..., :di], xbc[..., di : di + n], xbc[..., di + n :]
    dt = F.softplus(dt.float() + p_["dt_bias"].float())
    A = -torch.exp(p_["A_log"].float())
    xh = xin.reshape(b, s, heads, ph)
    xh = shard(xh, "batch", None, "inner_heads", None)
    ssm_init = None if init_state is None else init_state["ssm"]
    chunk = min(chunk, s)
    if want_cache:
        if s % chunk:
            raise ValueError(f"sequence {s} is not a multiple of the SSD chunk {chunk}")
        # x, B and C are read in place (widened to f32 in the kernel, which
        # is exact); y and the final state come back in f32.
        y, final = ssd_scan_heads(xh, dt, A, B, C,
                                  None if ssm_init is None else ssm_init.float().contiguous())
    else:
        # independent per (batch, head): each device scans its own block
        # under a sharding (B and C are shared by the heads)
        bh, b_, h_ = {0: 0, 2: 2}, {0: 0}, {2: 0}
        y, final = per_shard(
            lambda *t: _ssd_chunked(*t[:5], chunk, t[5]), xh, (0, 2),
            [(xh.float(), bh), (dt, bh), (A, h_), (B.float(), b_), (C.float(), b_),
             (ssm_init, {0: 0, 2: 1})], [bh, {0: 0, 2: 1}])
    y = y + xh.float() * p_["D"].float()[None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)
    y = y * F.silu(z)
    out = y @ p_["out_proj"]
    return out, {"ssm": final, "conv": conv_state}


def mamba2_decode(p_, x, state, cfg):
    """One-token recurrence. x: (B,1,d); state from mamba2_state_shape.

    Updates ``state["ssm"]`` (f32) and ``state["conv"]`` in place, where
    the reference returns new arrays; returns ``(out, state)``.
    """
    b = x.shape[0]
    di, ph, heads, n = _dims(cfg)
    z_all = x @ p_["in_proj"]
    z, xbc, dt = _split_proj(z_all, cfg)
    # conv: shift register
    ctx = torch.cat([state["conv"], xbc], dim=1)  # (B, k, C)
    w, bb = p_["conv_w"], p_["conv_b"]
    k = w.shape[0]
    out = sum(ctx[:, i] * w[i] for i in range(k)) + bb
    xbc = F.silu(out)[:, None]
    state["conv"].copy_(ctx[:, 1:])
    xin, B, C = xbc[..., :di], xbc[..., di : di + n], xbc[..., di + n :]
    dt = F.softplus(dt.float() + p_["dt_bias"].float())
    A = -torch.exp(p_["A_log"].float())
    xh = xin.reshape(b, 1, heads, ph).float()
    decay = torch.exp(dt[:, 0] * A[None, :])  # (b, h)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], B[:, 0].float(), xh[:, 0])
    ssm = state["ssm"]
    ssm.mul_(decay[:, :, None, None]).add_(upd)
    y = torch.einsum("bn,bhpn->bhp", C[:, 0].float(), ssm)
    y = y + xh[:, 0] * p_["D"].float()[None, :, None]
    y = y.reshape(b, 1, di).to(x.dtype) * F.silu(z)
    return y @ p_["out_proj"], state
