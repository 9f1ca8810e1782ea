"""The ssd_scan wrappers (``repro/kernels/ssd_scan/ops.py``).

Two entries share one launcher and one launch counter, ``ssd_scan.launches``:

* :func:`ssd_scan` keeps the reference's API and layout: one head per row
  of BH, its own B and C; returns y in ``x.dtype`` (the kernel writes f32,
  cast after).
* :func:`ssd_scan_heads` takes the Mamba-2 model's layout: xh (B, S, H, P)
  (a strided view is read in place), dt (B, S, H) f32, A (H,) f32, and one
  B and C (B, S, N) shared by every head; returns ``(y (B, S, H, P) f32,
  final_state (B, H, P, N) f32)``, the state the decode cache starts from.

On CPU tensors both run the plain sequential recurrence (``ref.py``); on
CUDA tensors they launch ``ssd_scan.cu`` on the current stream, or raise.
bf16 inputs go to the tensor-core kernel: one block per batch row and
group of :func:`heads_per_block` heads. Its tiles come by TMA where x, B
and C start and step on 16 bytes, else by ``cp.async`` copies of 8 or 4
bytes (:func:`copy_width`); rows that do not start and step on 4 bytes
(an odd element offset or stride) raise. f32 inputs go to the CUDA-core
kernel, which takes any strides. The kernels are a forward only, so both
entries refuse inputs that require grad. They tile 64 time steps whatever
``chunk`` the caller names: the chunked scan computes the same function
for any chunk length.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import build
from ..common import count_launch, resolve_device
from .ref import ssd_scan_heads_ref, ssd_scan_ref

__all__ = ["MAX_DIM", "copy_width", "heads_per_block", "ssd_scan", "ssd_scan_heads"]

#: Largest head dim P and state size N the kernel holds.
MAX_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NUM_STRIDES = 15
_COPY_WIDTHS = (16, 8, 4)


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        # Pointers and the stream as c_void_p: never cut to 32 bits.
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib.ssd_scan_heads_per_block.argtypes = []
        lib.ssd_scan_heads_per_block.restype = ctypes.c_int
    return lib


def heads_per_block() -> int:
    """Heads one block of the bf16 kernel scans (builds the library)."""
    return _lib().ssd_scan_heads_per_block()


def copy_width(*tensors: torch.Tensor) -> int:
    """The widest copy the bf16 kernel may use for these operands: the
    largest of 16, 8 and 4 bytes that divides every start address and every
    stride (in bytes) of a dim longer than 1. 16 loads the tiles by TMA, 8
    and 4 by ``cp.async`` copies of that size. A row's last dim must have
    unit stride; its length need not divide the width (the copy past it is
    zero-filled).

    Raises ValueError when not even 4 bytes divide them.
    """
    gcd = 0
    for t in tensors:
        gcd = math.gcd(gcd, t.data_ptr())
        for size, stride in zip(t.shape[:-1], t.stride()[:-1]):
            if size > 1:
                gcd = math.gcd(gcd, stride * t.element_size())
    for width in _COPY_WIDTHS:
        if gcd % width == 0:
            return width
    raise ValueError("bf16 x, b and c must start and step their rows on 4-byte "
                     f"boundaries (even element offsets and strides); they share only {gcd}")


def _check_tensors(**tensors) -> torch.device:
    device = None
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.requires_grad:
            raise RuntimeError(f"ssd_scan has no backward; {name} requires grad "
                               "(training runs the model's _ssd_chunked)")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
    return device


def _launch(xh, dt, a, b, c, y, state0, final, a_strides) -> None:
    """Launch on (B, S, H, P) views, y f32; ``a_strides`` = (batch, head)
    strides of a."""
    device = xh.device
    resolve_device(device)  # raises unless a capability-9.0 card (checked once per card)
    bsz, s, h, p = xh.shape
    n = b.shape[-1]
    if p > MAX_DIM or n > MAX_DIM:
        raise ValueError(f"head dim {p} and state {n} must be <= {MAX_DIM}")
    if bsz > 65535:
        raise ValueError(f"batch {bsz} exceeds the kernel's grid limit 65535")
    for name, t in (("xh", xh), ("b", b), ("c", c), ("y", y)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit stride on its last dim")
    width = copy_width(xh, b, c) if xh.dtype == torch.bfloat16 else 0
    strides = (*xh.stride()[:2], xh.stride(2), *dt.stride(), *a_strides,
               *b.stride()[:2], *c.stride()[:2], *y.stride()[:3])
    arr = (ctypes.c_longlong * _NUM_STRIDES)(*strides)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ssd_scan_launch(
            xh.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), state0.data_ptr() if state0 is not None else None,
            final.data_ptr() if final is not None else None,
            bsz, h, s, p, n, arr, _NUM_STRIDES, _DTYPES[xh.dtype], width, stream,
        )
    if rc != 0:
        raise RuntimeError("ssd_scan launch failed: " + lib.ssd_scan_error_string(rc).decode())
    count_launch(ssd_scan)


def _check_dtypes(x, b, c, dt, a) -> None:
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b and c must all be float32 or all bfloat16, got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"dt and a must be float32, got {dt.dtype}, {a.dtype}")


def ssd_scan(x, dt, a, b, c, *, chunk=128):
    """x (BH, S, P); dt (BH, S) > 0; a (BH, 1) < 0; b/c (BH, S, N) ->
    y (BH, S, P) in ``x.dtype``. Any S and any ``chunk >= 1``."""
    device = _check_tensors(x=x, dt=dt, a=a, b=b, c=c)
    _check_dtypes(x, b, c, dt, a)
    if x.ndim != 3 or dt.ndim != 2 or a.ndim != 2 or b.ndim != 3 or c.shape != b.shape:
        raise ValueError("expected x (BH, S, P), dt (BH, S), a (BH, 1), b/c (BH, S, N)")
    bh, s, _ = x.shape
    if dt.shape != (bh, s) or a.shape != (bh, 1) or b.shape[:2] != (bh, s):
        raise ValueError(f"dt {tuple(dt.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)} "
                         f"do not match x {tuple(x.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if device.type == "cpu":
        return ssd_scan_ref(x, dt, a, b, c)
    y = torch.empty(x.shape, dtype=torch.float32, device=device)
    # (BH, S, P) is the model layout with H = 1; a has one value per row.
    _launch(x[:, :, None], dt[:, :, None], a, b, c, y[:, :, None], None, None,
            (a.stride(0), 0))
    return y.to(x.dtype)


def ssd_scan_heads(xh, dt, a, b, c, state0=None):
    """The model-layout scan: xh (B, S, H, P) f32 or bf16, may be a strided
    view (unit stride on P); dt (B, S, H) f32; a (H,) f32; b/c (B, S, N),
    xh's dtype, shared by the heads; ``state0`` (B, H, P, N) f32 or None.

    Returns ``(y (B, S, H, P) f32, final_state (B, H, P, N) f32)``.
    """
    tensors = dict(xh=xh, dt=dt, a=a, b=b, c=c)
    if state0 is not None:
        tensors["state0"] = state0
    device = _check_tensors(**tensors)
    _check_dtypes(xh, b, c, dt, a)
    if xh.ndim != 4 or b.ndim != 3 or c.shape != b.shape:
        raise ValueError("expected xh (B, S, H, P), b/c (B, S, N)")
    bsz, s, h, p = xh.shape
    n = b.shape[-1]
    if dt.shape != (bsz, s, h) or a.shape != (h,) or b.shape[:2] != (bsz, s):
        raise ValueError(f"dt {tuple(dt.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)} "
                         f"do not match xh {tuple(xh.shape)}")
    if state0 is not None and (state0.shape != (bsz, h, p, n) or state0.dtype != torch.float32
                               or not state0.is_contiguous()):
        raise ValueError(f"state0 must be a contiguous f32 {(bsz, h, p, n)}")
    if device.type == "cpu":
        return ssd_scan_heads_ref(xh, dt, a, b, c, state0)
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=device)
    final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=device)
    if s == 0:  # nothing to scan: no launch
        if state0 is None:
            return y, final.zero_()
        return y, final.copy_(state0)
    _launch(xh, dt, a, b, c, y, state0, final, (0, a.stride(0)))
    return y, final


ssd_scan.launches = ssd_scan.captured_launches = 0
