"""The ``chunk_gather_train`` and ``chunk_gather`` wrappers
(``repro/kernels/chunk_gather/ops.py``).

On CPU tensors they run the plain versions (``ref.py``); on CUDA tensors
they launch the kernels in ``chunk_gather.cu`` on the current stream, or
raise. ``chunk_gather_train.launches`` and ``chunk_gather.launches``
count each kernel's launches, and only those.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import build
from ..common import checked_cuda, resolve_device
from .ref import chunk_gather_ref, chunk_gather_train_ref

__all__ = ["check_indices", "chunk_gather", "chunk_gather_train", "vector_path"]


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(build.load("chunk_gather"))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launchers' C signatures on a build of ``chunk_gather.cu``."""
    # Pointers and the stream as c_void_p: never cut to 32 bits.
    lib.chunk_gather_train_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.chunk_gather_train_launch.restype = ctypes.c_int
    lib.chunk_gather_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.chunk_gather_launch.restype = ctypes.c_int
    lib.chunk_gather_error_string.argtypes = [ctypes.c_int]
    lib.chunk_gather_error_string.restype = ctypes.c_char_p
    return lib


def _launch(device: torch.device, name: str, *args) -> None:
    """Launch ``name`` on ``device``'s current stream; raise if refused.

    Kept lean, since at the trainer's shape the host path costs more than
    the kernel: the card's capability check is cached per card, the stream
    is read as a raw handle (no Stream object), and the device guard is
    entered only when the card is not the current one.
    """
    if device.type != "cuda":
        resolve_device(device)  # raises: the kernels run on CUDA or the CPU only
    index = device.index
    checked_cuda(index)  # raises unless a capability-9.0 card (checked once per card)
    lib = _lib()
    fn = getattr(lib, f"{name}_launch")
    if torch.cuda.current_device() == index:
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: " + lib.chunk_gather_error_string(rc).decode())


def vector_path(chunk_tokens: torch.Tensor, row_len: int) -> bool:
    """Whether the kernels take their 16-byte path for these slot rows and
    output rows of ``row_len`` tokens: the slot buffer starts on 16 bytes,
    and its row stride and ``row_len`` are multiples of 4 tokens (the
    outputs, one fresh allocation, then start each row on 16 bytes too).
    Otherwise they take their scalar path."""
    return (row_len % 4 == 0 and chunk_tokens.shape[1] % 4 == 0
            and chunk_tokens.data_ptr() % 16 == 0)


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


def _check(chunk_tokens, record_lens, indices, seq_len: int | None) -> None:
    """Types, shapes and devices; ``seq_len`` None for the raw gather."""
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
    if seq_len is None:
        return
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
    b, u, lp = indices.shape[0], chunk_tokens.shape[0], chunk_tokens.shape[1]
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit 65535")
    # One allocation, three views: tokens, targets, and the mask as f32.
    tokens, targets, mask = torch.empty((3, b, seq_len), dtype=torch.int32,
                                        device=device).unbind()
    mask = mask.view(torch.float32)
    _launch(device, "chunk_gather_train",
            chunk_tokens.data_ptr(), record_lens.data_ptr(), indices.data_ptr(),
            tokens.data_ptr(), targets.data_ptr(), mask.data_ptr(),
            u, b, seq_len, lp, int(pad_id), int(vector_path(chunk_tokens, seq_len)))
    chunk_gather_train.launches += 1
    return tokens, targets, mask


chunk_gather_train.launches = 0


def chunk_gather(chunk_tokens, record_lens, indices, *, pad_id=0):
    """The raw redirected gather: the selected slot rows, padded past each
    record's length. ``chunk_tokens`` (U, L) int32, ``record_lens`` (U,)
    int32, ``indices`` (B,) int32. Returns ``(tokens (B, L) int32,
    mask (B, L) f32)``, the mask 1 where ``pos < record_lens[idx]``. The
    index check is ``chunk_gather_train``'s: raised on the host for CPU
    tensors; on CUDA the kernel pads a row it cannot read.
    """
    _check(chunk_tokens, record_lens, indices, None)
    device = chunk_tokens.device
    if device.type == "cpu":
        check_indices(indices, chunk_tokens.shape[0])
        return chunk_gather_ref(chunk_tokens, record_lens, indices, pad_id=pad_id)
    b, (u, row_len) = indices.shape[0], chunk_tokens.shape
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit 65535")
    tokens, mask = torch.empty((2, b, row_len), dtype=torch.int32, device=device).unbind()
    mask = mask.view(torch.float32)
    _launch(device, "chunk_gather",
            chunk_tokens.data_ptr(), record_lens.data_ptr(), indices.data_ptr(),
            tokens.data_ptr(), mask.data_ptr(), u, b, row_len, int(pad_id),
            int(vector_path(chunk_tokens, row_len)))
    chunk_gather.launches += 1
    return tokens, mask


chunk_gather.launches = 0
