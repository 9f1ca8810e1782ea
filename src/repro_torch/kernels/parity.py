"""Kernel-vs-plain parity registry for the port's CUDA kernels.

The counterpart of ``repro/kernels/parity.py``, for all five kernels.
Each entry carries the reference registry's shape grid and
per-dtype tolerance (copied, not imported: the port does not import the
JAX package), its deterministic input generator (same seeding, same
draws), and the kernel and its plain PyTorch version. Errors are the
reference's scale-normalised max abs error (:func:`max_err`).
``chip_smoke.py`` holds every kernel to its plain version on the card over
these shapes plus the shapes the main paths give it; the CPU tests hold
the plain version to the JAX function over the same grid.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from .chunk_gather.ops import chunk_gather, chunk_gather_train
from .chunk_gather.ref import chunk_gather_ref, chunk_gather_train_ref
from .common import round_up
from .decode_attention.ops import decode_attention
from .decode_attention.ref import decode_attention_plain
from .flash_attention.ops import flash_attention
from .flash_attention.ref import attention_ref
from .ssd_scan.ops import ssd_scan
from .ssd_scan.ref import ssd_scan_ref

__all__ = ["KERNELS", "KernelCase", "iter_cases", "make_inputs", "max_err", "run_kernel",
           "run_ref"]


@dataclasses.dataclass(frozen=True)
class KernelCase:
    """One cell of a kernel's parity grid."""

    kernel: str     # registry key
    shape: tuple    # kernel-specific shape tuple (see KERNELS[...]["shapes"])
    dtype: str      # dtype name

    @property
    def name(self) -> str:
        dims = "x".join(str(d) for d in self.shape)
        return f"{self.kernel}[{dims}]{self.dtype}"


KERNELS: dict[str, dict] = {
    "flash_attention": {
        # (bh, s, d, causal)
        "shapes": [
            (2, 128, 32, True), (2, 128, 32, False),
            (4, 256, 64, True), (4, 256, 64, False),
            (3, 192, 64, True),
            (1, 512, 128, True),
        ],
        "tols": {"float32": 2e-5, "bfloat16": 2e-2},
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:80",
        "source": "src/repro_torch/kernels/flash_attention/flash_attention.cu",
    },
    "decode_attention": {
        # (b, h, kvh, s, d)
        "shapes": [
            (2, 8, 2, 512, 64),
            (1, 4, 4, 256, 32),
            (3, 16, 4, 1024, 128),
        ],
        "tols": {"float32": 2e-5, "bfloat16": 2e-2},
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:63",
        "source": "src/repro_torch/kernels/decode_attention/decode_attention.cu",
    },
    "ssd_scan": {
        # (bh, s, p, n, chunk)
        "shapes": [
            (4, 256, 64, 16, 64),
            (2, 128, 32, 32, 32),
            (1, 512, 64, 64, 128),
        ],
        "tols": {"float32": 2e-4, "bfloat16": 5e-2},
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:67",
        "source": "src/repro_torch/kernels/ssd_scan/ssd_scan.cu",
    },
    "chunk_gather": {
        # (num_slots, L, B)
        "shapes": [(64, 128, 16), (32, 256, 8), (16, 64, 32), (128, 512, 4)],
        "tols": {"int32": 0.0},
        "replaces": "src/repro/kernels/chunk_gather/chunk_gather.py:59",
        "source": "src/repro_torch/kernels/chunk_gather/chunk_gather.cu",
    },
    "chunk_gather_train": {
        # (num_slots, seq_len, B); slot rows padded like the reference's cases
        "shapes": [(64, 128, 16), (32, 100, 8), (16, 64, 32)],
        "tols": {"int32": 0.0},
        "replaces": "src/repro/kernels/chunk_gather/chunk_gather.py:112",
        "source": "src/repro_torch/kernels/chunk_gather/chunk_gather.cu",
    },
}


def iter_cases(kernel: str | None = None) -> list[KernelCase]:
    """Every (shape, dtype) cell of the grid, or of one kernel's grid."""
    out = []
    for name, spec in KERNELS.items():
        if kernel is not None and name != kernel:
            continue
        for shape in spec["shapes"]:
            for dtype in spec["tols"]:
                out.append(KernelCase(name, shape, dtype))
    return out


def make_inputs(case: KernelCase, seed: int = 0, *, device="cpu", row_pad: int = 128) -> tuple:
    """The reference's inputs for ``case`` (same generator, same draws).

    ``row_pad`` is the slot-row padding: the reference's cases pad to 128
    (its TPU lane width); the trainer's packer pads to 8.
    """
    # zlib.crc32, not hash(): stable across processes (PYTHONHASHSEED).
    rng = np.random.default_rng((seed, zlib.crc32(case.kernel.encode()), *case.shape))
    if case.kernel in ("flash_attention", "decode_attention"):
        dt = getattr(torch, case.dtype)

        def normal(*shape):
            return torch.as_tensor(rng.normal(size=shape), device=device).to(dt)

        if case.kernel == "flash_attention":
            bh, s, d, _ = case.shape
            return tuple(normal(bh, s, d) for _ in range(3))
        b, h, kvh, s, d = case.shape
        q, ck, cv = normal(b, h, d), normal(b, s, kvh, d), normal(b, s, kvh, d)
        return q, ck, cv, torch.as_tensor(rng.random((b, s)) < 0.75, device=device)
    if case.kernel == "ssd_scan":
        dt = getattr(torch, case.dtype)
        bh, s, p, n, _ = case.shape
        x = torch.as_tensor(rng.normal(size=(bh, s, p)), device=device).to(dt)
        dts = torch.as_tensor(rng.random((bh, s)) * 0.5 + 0.01, device=device).float()
        a = torch.as_tensor(-rng.random((bh, 1)) * 2 - 0.1, device=device).float()
        b = torch.as_tensor(rng.normal(size=(bh, s, n)), device=device).to(dt)
        c = torch.as_tensor(rng.normal(size=(bh, s, n)), device=device).to(dt)
        return x, dts, a, b, c
    if case.kernel == "chunk_gather":
        slots, length, batch = case.shape
        ct = rng.integers(1, 1000, (slots, length))
        lens = rng.integers(1, length + 1, (slots,))
        idx = rng.integers(0, slots, (batch,))
        return tuple(
            torch.as_tensor(np.asarray(a, np.int32), device=device) for a in (ct, lens, idx)
        )
    if case.kernel == "chunk_gather_train":
        slots, seq_len, batch = case.shape
        lp = round_up(seq_len + 1, row_pad)
        lens = rng.integers(1, seq_len + 2, (slots,))
        ct = np.zeros((slots, lp), np.int32)
        for i, n in enumerate(lens):
            ct[i, :n] = rng.integers(1, 1000, n)
        idx = rng.integers(0, slots, (batch,))
        return tuple(
            torch.as_tensor(np.asarray(a, np.int32), device=device) for a in (ct, lens, idx)
        )
    raise ValueError(f"unknown kernel {case.kernel!r}")


def run_kernel(case: KernelCase, inputs: tuple):
    if case.kernel == "flash_attention":
        return flash_attention(*inputs, causal=case.shape[3])
    if case.kernel == "decode_attention":
        return decode_attention(*inputs)
    if case.kernel == "ssd_scan":
        return ssd_scan(*inputs, chunk=case.shape[4])
    if case.kernel == "chunk_gather":
        return chunk_gather(*inputs)
    if case.kernel == "chunk_gather_train":
        return chunk_gather_train(*inputs, seq_len=case.shape[1])
    raise ValueError(f"unknown kernel {case.kernel!r}")


def run_ref(case: KernelCase, inputs: tuple):
    if case.kernel == "flash_attention":
        return attention_ref(*inputs, causal=case.shape[3])
    if case.kernel == "decode_attention":
        return decode_attention_plain(*inputs)
    if case.kernel == "ssd_scan":
        return ssd_scan_ref(*inputs)
    if case.kernel == "chunk_gather":
        return chunk_gather_ref(*inputs)
    if case.kernel == "chunk_gather_train":
        return chunk_gather_train_ref(*inputs, seq_len=case.shape[1])
    raise ValueError(f"unknown kernel {case.kernel!r}")


def _leaves(out) -> list:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def max_err(out, ref) -> float:
    """Scale-normalised max abs error, maxed over output leaves:
    ``max |out - ref| / (max |ref| + 1e-6)`` in f32 (the reference's
    ``_max_err``)."""
    worst = 0.0
    for o, r in zip(_leaves(out), _leaves(ref)):
        o32 = o.detach().float()
        r32 = r.detach().float().to(o32.device)
        scale = float(r32.abs().max()) + 1e-6 if r32.numel() else 1e-6
        worst = max(worst, float((o32 - r32).abs().max()) / scale if o32.numel() else 0.0)
    return worst
