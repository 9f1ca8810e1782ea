"""Plain PyTorch versions of ssd_scan (``repro/kernels/ssd_scan/ref.py``).

The CPU path of the wrappers and the yardstick the CUDA kernel is held to
on the card: the naive sequential SSM recurrence, one step per token, in
f32,

    h_t = exp(a dt_t) h_{t-1} + dt_t x_t b_tᵀ        ((P, N) state from 0)
    y_t = h_t c_t

:func:`ssd_scan_ref` takes the reference kernel's layout (a head per row
of BH, its own B and C); :func:`ssd_scan_heads_ref` the Mamba-2 model's
(heads inside the sequence layout, one B and C shared by every head,
``n_groups = 1``), and it also returns the final state.
"""

from __future__ import annotations

import torch

__all__ = ["ssd_scan_heads_ref", "ssd_scan_ref"]


def ssd_scan_ref(x, dt, a, b, c):
    """x (BH, S, P); dt (BH, S); a (BH, 1); b/c (BH, S, N) -> y (BH, S, P)
    in ``x.dtype``."""
    y, _ = ssd_scan_heads_ref(x[:, :, None], dt[:, :, None], a[:, :1], b, c)
    return y[:, :, 0].to(x.dtype)


def ssd_scan_heads_ref(xh, dt, a, b, c, state0=None):
    """xh (B, S, H, P); dt (B, S, H); a (H,) or (B, H); b/c (B, S, N)
    shared by the heads; ``state0`` (B, H, P, N) or None (zeros).

    Returns ``(y (B, S, H, P) f32, final_state (B, H, P, N) f32)``.
    """
    bsz, s, h, p = xh.shape
    n = b.shape[-1]
    x32, dt32, b32, c32 = xh.float(), dt.float(), b.float(), c.float()
    a32 = a.float().expand(bsz, h)
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=xh.device)
             if state0 is None else state0.float().clone())
    ys = []
    for t in range(s):
        decay = torch.exp(a32 * dt32[:, t])                       # (B, H)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt32[:, t], b32[:, t], x32[:, t])
        state = state * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, c32[:, t]))
    y = torch.stack(ys, dim=1) if ys else x32.new_zeros((bsz, 0, h, p))
    return y, state
