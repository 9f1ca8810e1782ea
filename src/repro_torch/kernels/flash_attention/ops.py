"""The flash-attention wrappers (``repro/kernels/flash_attention/ops.py``).

On CPU tensors they run the plain version (``ref.py``); on CUDA tensors
they launch the kernel in ``flash_attention.cu`` on the current stream, or
raise. The kernel is a forward only, so both wrappers refuse inputs that
require grad: it can never slip into a training step unseen.
``flash_attention.launches`` counts kernel launches from either wrapper,
and only those. ``softcap > 0`` caps the scaled logits at ``softcap *
tanh(s / softcap)`` before the mask (the reference's ``logit_softcap``);
0 launches the uncapped instantiation.

The bf16 kernel's persistent blocks take work items from two int32
counters that each launch leaves at 0 (``common.zeroed_counters``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from ..common import count_launch, resolve_device, zeroed_counters
from .ref import attention_gqa_ref, attention_ref

__all__ = ["HEAD_DIMS", "flash_attention", "flash_attention_gqa"]

#: Head dims the CUDA kernel is instantiated for.
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        # Pointers and the stream as c_void_p: never cut to 32 bits.
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, window, softcap) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.requires_grad:
            raise RuntimeError(f"flash_attention has no backward; {name} requires grad "
                               "(use the model's plain attention for training)")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}; q, k and v must all be float32 or "
                            "all bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not 0.0 <= softcap < float("inf"):
        raise ValueError(f"softcap must be a finite number >= 0, got {softcap}")


def _launch(q, k, v, causal: bool, window: int, softcap: float):
    """q (B, S, H, D), k/v (B, S, KVH, D) on the card -> (B, S, H, D)."""
    device = q.device
    resolve_device(device)  # raises unless a capability-9.0 card (checked once per card)
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one the kernel is built for {HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):  # TMA's base-address rule
        raise ValueError("q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    sched = zeroed_counters("flash_attention", device, 2) if q.dtype == torch.bfloat16 else None
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if sched is None else sched.data_ptr(), b, h, kvh, s, d,
            int(bool(causal)), int(window), _DTYPES[q.dtype], float(softcap), stream,
        )
    if rc != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    count_launch(flash_attention)
    return out


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """(BH, S, D) attention, causal and/or sliding-window, logits capped at
    ``softcap`` when it is > 0; any S."""
    _check(q, k, v, window, softcap)
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v of one (BH, S, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    return _launch(q[:, :, None], k[:, :, None], v[:, :, None], causal, window,
                   softcap)[:, :, 0]


def flash_attention_gqa(q, k, v, *, causal=True, window=0, softcap=0.0):
    """(B, S, H, D) x (B, S, KVH, D) GQA attention -> (B, S, H, D).

    Query head ``h`` attends with kv head ``h // (H // KVH)``, as the
    reference's ``jnp.repeat`` expand gives; the kernel reads that head in
    place instead of expanding it in memory. ``softcap`` as
    :func:`flash_attention`'s.
    """
    _check(q, k, v, window, softcap)
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, S, H, D) and k/v (B, S, KVH, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of {k.shape[2]} kv heads")
    if q.device.type == "cpu":
        return attention_gqa_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    return _launch(q, k, v, causal, window, softcap)


flash_attention.launches = flash_attention.captured_launches = 0
