"""Kernel-vs-plain parity registry for the port's CUDA kernels.

The counterpart of ``repro/kernels/parity.py``, for the kernels ported so
far. Each entry carries the reference registry's shape grid and exact
tolerance (copied, not imported: the port does not import the JAX
package), a deterministic input generator, and the kernel and its plain
PyTorch version. ``chip_smoke.py`` holds every kernel to its plain version
on the card over these shapes plus the shapes the trainer gives it; the
CPU tests hold the plain version to the JAX function over the same grid.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from .chunk_gather.ops import chunk_gather_train
from .chunk_gather.ref import chunk_gather_train_ref
from .common import round_up

__all__ = ["KERNELS", "KernelCase", "iter_cases", "make_inputs", "run_kernel", "run_ref"]


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
    "chunk_gather_train": {
        # (num_slots, seq_len, B); slot rows padded like the reference's cases
        "shapes": [(64, 128, 16), (32, 100, 8), (16, 64, 32)],
        "tols": {"int32": 0.0},
        "replaces": "src/repro/kernels/chunk_gather/chunk_gather.py:112",
        "source": "src/repro_torch/kernels/chunk_gather/chunk_gather.cu",
    },
}


def iter_cases() -> list[KernelCase]:
    out = []
    for kernel, spec in KERNELS.items():
        for shape in spec["shapes"]:
            for dtype in spec["tols"]:
                out.append(KernelCase(kernel, shape, dtype))
    return out


def make_inputs(case: KernelCase, seed: int = 0, *, device="cpu", row_pad: int = 128) -> tuple:
    """The reference's inputs for ``case`` (same generator, same draws).

    ``row_pad`` is the slot-row padding: the reference's cases pad to 128
    (its TPU lane width); the trainer's packer pads to 8.
    """
    rng = np.random.default_rng((seed, zlib.crc32(case.kernel.encode()), *case.shape))
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
    if case.kernel == "chunk_gather_train":
        return chunk_gather_train(*inputs, seq_len=case.shape[1])
    raise ValueError(f"unknown kernel {case.kernel!r}")


def run_ref(case: KernelCase, inputs: tuple):
    if case.kernel == "chunk_gather_train":
        return chunk_gather_train_ref(*inputs, seq_len=case.shape[1])
    raise ValueError(f"unknown kernel {case.kernel!r}")

