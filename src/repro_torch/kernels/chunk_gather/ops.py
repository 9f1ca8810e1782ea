"""The ``chunk_gather_train`` wrapper (``repro/kernels/chunk_gather/ops.py``).

On CPU tensors it runs the plain version (``ref.py``); on CUDA tensors it
launches the kernel in ``chunk_gather.cu`` on the current stream, or
raises. ``chunk_gather_train.launches`` counts kernel launches, and only
those.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import build
from ..common import resolve_device
from .ref import chunk_gather_train_ref

__all__ = ["check_indices", "chunk_gather_train"]


def _lib() -> ctypes.CDLL:
    lib = build.load("chunk_gather")
    fn = lib.chunk_gather_train_launch
    if fn.argtypes is None:
        # Pointers and the stream as c_void_p: never cut to 32 bits.
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.chunk_gather_error_string.argtypes = [ctypes.c_int]
        lib.chunk_gather_error_string.restype = ctypes.c_char_p
    return lib


def check_indices(indices, num_slots: int) -> None:
    """Raise unless every redirection index lies in ``[0, num_slots)``.

    Host-side (numpy array or CPU tensor): the stager calls it on the
    packed batch before the copy to the device, where the check would
    cost a synchronisation.
    """
    idx = indices.numpy() if isinstance(indices, torch.Tensor) else np.asarray(indices)
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= num_slots):
        raise IndexError(
            f"redirection index out of range [0, {num_slots}): "
            f"min {int(idx.min())}, max {int(idx.max())}"
        )


def _check(chunk_tokens, record_lens, indices, seq_len: int) -> None:
    for name, t in (("chunk_tokens", chunk_tokens), ("record_lens", record_lens),
                    ("indices", indices)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != chunk_tokens.device:
            raise ValueError(f"{name} is on {t.device}, chunk_tokens on "
                             f"{chunk_tokens.device}")
    if chunk_tokens.ndim != 2 or record_lens.ndim != 1 or indices.ndim != 1:
        raise ValueError("expected chunk_tokens (U, Lp), record_lens (U,), indices (B,)")
    if record_lens.shape[0] != chunk_tokens.shape[0]:
        raise ValueError(f"record_lens {tuple(record_lens.shape)} does not match "
                         f"{chunk_tokens.shape[0]} slots")
    if chunk_tokens.shape[1] < seq_len + 1:
        raise ValueError(f"slot rows of {chunk_tokens.shape[1]} < seq_len + 1 = "
                         f"{seq_len + 1}")
    if seq_len < 0:
        raise ValueError(f"seq_len must be >= 0, got {seq_len}")


def chunk_gather_train(chunk_tokens, record_lens, indices, *, seq_len, pad_id=0):
    """Fused redirected gather + next-token shift + length mask.

    ``chunk_tokens`` (U, Lp) int32 slot rows with Lp >= seq_len + 1,
    ``record_lens`` (U,) int32, ``indices`` (B,) int32. Returns
    ``(tokens (B, S) int32, targets (B, S) int32, loss_mask (B, S) f32)``.
    On CUDA the indices must have been checked on the host
    (:func:`check_indices`); the kernel pads a row it cannot read.
    """
    _check(chunk_tokens, record_lens, indices, seq_len)
    device = chunk_tokens.device
    if device.type == "cpu":
        check_indices(indices, chunk_tokens.shape[0])
        return chunk_gather_train_ref(
            chunk_tokens, record_lens, indices, seq_len=seq_len, pad_id=pad_id
        )
    resolve_device(device)  # raises unless a capability-9.0 card (checked once per card)
    b, u, lp = indices.shape[0], chunk_tokens.shape[0], chunk_tokens.shape[1]
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit 65535")
    tokens = torch.empty((b, seq_len), dtype=torch.int32, device=device)
    targets = torch.empty((b, seq_len), dtype=torch.int32, device=device)
    mask = torch.empty((b, seq_len), dtype=torch.float32, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.chunk_gather_train_launch(
            chunk_tokens.data_ptr(), record_lens.data_ptr(), indices.data_ptr(),
            tokens.data_ptr(), targets.data_ptr(), mask.data_ptr(),
            u, b, seq_len, lp, int(pad_id), stream,
        )
    if rc != 0:
        raise RuntimeError("chunk_gather_train launch failed: "
                           + lib.chunk_gather_error_string(rc).decode())
    chunk_gather_train.launches += 1
    return tokens, targets, mask


chunk_gather_train.launches = 0
