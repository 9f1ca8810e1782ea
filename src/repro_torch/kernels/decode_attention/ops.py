"""The ``decode_attention`` wrapper (``repro/kernels/decode_attention/ops.py``).

On CPU tensors it runs the plain version (``ref.py``); on CUDA tensors it
launches the kernel in ``decode_attention.cu`` on the current stream, or
raises. ``decode_attention.launches`` counts kernel launches, and only
those (one per call: the splits of S merge inside the same launch).
``softcap > 0`` caps the scaled scores at ``softcap * tanh(s / softcap)``
before the mask (the reference's ``logit_softcap``); 0 launches the
uncapped instantiation.

The kernel's split merge takes tickets from int32 counters that each
launch leaves at 0 (``common.zeroed_counters``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from ..common import count_launch, resolve_device, zeroed_counters
from .ref import decode_attention_plain

__all__ = ["HEAD_DIMS", "decode_attention", "query_group"]

#: Head dims the CUDA kernel is instantiated for.
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TARGET_BLOCKS_PER_SM = 1
_MIN_ROWS_PER_SPLIT = 256
_MAX_QUERY_GROUP = 8


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        # Pointers and the stream as c_void_p: never cut to 32 bits.
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def query_group(g: int) -> int:
    """The query group a block serves: the smallest of 1, 2, 4, 8 that
    covers ``g`` query heads per kv head; a larger ``g`` runs in groups of 8."""
    if g < 1:
        raise ValueError(f"need at least one query head per kv head, got {g}")
    return min(_MAX_QUERY_GROUP, 1 << (g - 1).bit_length())


def _splits(blocks: int, s: int, sms: int) -> int:
    """How many parts the cache length is split into: only as far as
    ``blocks`` (one per batch, kv head and query group) leave the card short
    of one block per SM, each part at least 256 cache rows. (On an H100 at
    tinyllama's decode shape, 4 splits ran faster than 8: each split adds
    a partial to merge, and one block per SM already keeps enough bytes in
    flight.)"""
    want = _TARGET_BLOCKS_PER_SM * sms // blocks
    return max(1, min(want, -(-s // _MIN_ROWS_PER_SPLIT), 65535))


def _check(q, cache_k, cache_v, mask, softcap) -> None:
    for name, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v), ("mask", mask)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.requires_grad:
            raise RuntimeError(f"decode_attention has no backward; {name} requires grad")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if cache_k.dtype != q.dtype or cache_v.dtype != q.dtype:
        raise TypeError(f"cache dtypes {cache_k.dtype}/{cache_v.dtype} differ from q's {q.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if q.ndim != 3 or cache_k.ndim != 4 or mask.ndim != 2:
        raise ValueError("expected q (B, H, D), cache_k/v (B, S, KVH, D), mask (B, S)")
    b, h, d = q.shape
    _, s, kvh, dk = cache_k.shape
    if cache_v.shape != cache_k.shape or cache_k.shape[0] != b or dk != d:
        raise ValueError(f"cache {tuple(cache_k.shape)}/{tuple(cache_v.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} kv heads")
    if tuple(mask.shape) != (b, s):
        raise ValueError(f"mask {tuple(mask.shape)} is not (B, S) = {(b, s)}")
    if s == 0:
        raise ValueError("the cache has no slots")
    if not 0.0 <= softcap < float("inf"):
        raise ValueError(f"softcap must be a finite number >= 0, got {softcap}")


def decode_attention(q, cache_k, cache_v, mask, *, softcap=0.0):
    """One-token GQA attention against a KV cache.

    ``q`` (B, H, D); ``cache_k``/``cache_v`` (B, S, KVH, D); ``mask``
    (B, S) bool, True where a slot holds a valid position (ring buffers
    included). Returns (B, H, D) in ``q.dtype``; a row with no valid slot
    is zeros. Query head ``h`` reads kv head ``h // (H // KVH)``. Scores
    are capped at ``softcap`` when it is > 0.
    """
    _check(q, cache_k, cache_v, mask, softcap)
    device = q.device
    if device.type in ("cpu", "meta"):  # meta: the dry run's shapes, no data
        return decode_attention_plain(q, cache_k, cache_v, mask, softcap)
    resolve_device(device)  # raises unless a capability-9.0 card (checked once per card)
    b, h, d = q.shape
    s, kvh = cache_k.shape[1], cache_k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one the kernel is built for {HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in (q, cache_k, cache_v)):
        raise ValueError("q and the caches must be 16-byte aligned")
    g = h // kvh
    gq = query_group(g)
    blocks = b * kvh * -(-g // gq)
    splits = _splits(blocks, s, _sm_count(device.index or 0))
    out = torch.empty_like(q)
    part = tickets = None
    if splits > 1:
        part = torch.empty((blocks, splits, gq, d + 2), dtype=torch.float32, device=device)
        tickets = zeroed_counters("decode_attention", device, blocks)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.decode_attention_launch(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(),
            None if tickets is None else tickets.data_ptr(), b, kvh, g, s, d, gq, splits,
            _DTYPES[q.dtype], float(softcap), stream,
        )
    if rc != 0:
        raise RuntimeError("decode_attention launch failed: "
                           + lib.decode_attention_error_string(rc).decode())
    count_launch(decode_attention)
    return out


decode_attention.launches = decode_attention.captured_launches = 0
