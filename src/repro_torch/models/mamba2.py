"""Mamba-2 (SSD) block [arXiv:2405.21060] (``repro/models/mamba2.py``).

State-space duality form: per head with state size n,
    h_t = exp(A·dt_t) · h_{t-1} + dt_t · B_t x_tᵀ        (n × p state)
    y_t = C_tᵀ h_t + D · x_t
with scalar A < 0 per head, data-dependent dt, and one B and C shared by
every head (n_groups = 1, as in zamba2-1.2b). Op for op the reference's.

The scan takes one of two routes, as attention does (``attention.py``):
prefill (``want_cache``, no gradient) runs it in the ``ssd_scan`` kernel's
model-layout entry, which reads x, B and C in place in the conv output and
returns the final state; training keeps the plain chunked scan
:func:`_ssd_chunked`, which autograd differentiates. Decode is the O(1)
recurrence in plain PyTorch (the reference has no kernel for it), and
updates the SSM and conv states in place.
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
    """Chunked SSD scan, the plain (training) route.

    xh: (b, s, h, p) head inputs; dt: (b, s, h) positive step sizes;
    A: (h,) negative decay rates; B, C: (b, s, n).
    Returns (y (b,s,h,p), final_state (b,h,p,n)).
    """
    b, s, h, p = xh.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the SSD chunk {chunk}")
    nc = s // chunk
    la = dt * A[None, None, :]  # log decay per step (b, s, h) (negative)

    xc = xh.reshape(b, nc, chunk, h, p).transpose(0, 1)
    dtc = dt.reshape(b, nc, chunk, h).transpose(0, 1)
    lac = la.reshape(b, nc, chunk, h).transpose(0, 1)
    Bc = B.reshape(b, nc, chunk, n).transpose(0, 1)
    Cc = C.reshape(b, nc, chunk, n).transpose(0, 1)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))

    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
             if ssm_init is None else ssm_init.float())
    ys = []
    for xcc, dcc, lcc, Bcc, Ccc in zip(xc, dtc, lac, Bc, Cc):
        seg = torch.cumsum(lcc, dim=1)      # (b, chunk, h) inclusive log-decay
        total = seg[:, -1]                  # (b, h)
        # intra: L[i,j] = exp(seg_i - seg_j), i >= j (decay over j+1..i)
        li = seg[:, :, None, :]
        lj = seg[:, None, :, :]
        decay = torch.exp(torch.where(mask[None, :, :, None], li - lj, -torch.inf))
        cb = torch.einsum("bqn,bkn->bqk", Ccc, Bcc)
        y = torch.einsum("bqk,bqkh,bkh,bkhp->bqhp", cb, decay, dcc, xcc)
        # inter: contribution of the state entering this chunk
        y = y + torch.einsum("bqn,bqh,bhpn->bqhp", Ccc, torch.exp(seg), carry)
        # state update: S = S*exp(total) + sum_j exp(total - seg_j) dt_j B_j x_j^T
        wdec = torch.exp(total[:, None, :] - seg) * dcc   # (b, k, h)
        st = torch.einsum("bkh,bkn,bkhp->bhpn", wdec, Bcc, xcc)
        carry = carry * torch.exp(total)[:, :, None, None] + st
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y, carry


def mamba2_block(p_, x, cfg, *, init_state=None, chunk=None, want_cache=False):
    """x: (B,S,d) -> (y, {"ssm","conv"} final state).

    ``want_cache`` (prefill: no gradient) runs the scan in the ``ssd_scan``
    kernel; otherwise the plain chunked scan runs. Either way S must be at
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
