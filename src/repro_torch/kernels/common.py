"""Shared kernel-dispatch conventions.

The counterpart of ``repro/kernels/common.py``: there ``interpret=None``
picks compiled Pallas on a TPU and the interpreter elsewhere. Here the
choice is the device. ``resolve_device()`` defaults to the CUDA card and
refuses anything but a Hopper (capability 9.0) card; the CPU is taken only
when the caller asks for it, and then the kernels' plain versions run.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["resolve_device", "round_up"]

#: Compute capability the CUDA sources are built for (``sm_90a``).
CAPABILITY = (9, 0)


def round_up(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= ``n``."""
    return -(-n // multiple) * multiple


def resolve_device(device=None) -> torch.device:
    """Resolve a device request to a concrete ``torch.device``.

    ``None`` -> the current CUDA card. ``"cpu"`` -> the CPU (tests, and
    the plain kernel versions). A CUDA request raises if there is no card
    or the card is not capability (9, 0); it never falls back to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    return _checked_cuda(dev.index if dev.index is not None else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _checked_cuda(index: int) -> torch.device:
    """``cuda:index`` once its capability has been checked (once per card)."""
    cap = torch.cuda.get_device_capability(index)
    if cap != CAPABILITY:
        raise RuntimeError(
            f"cuda:{index} ({torch.cuda.get_device_name(index)}) has "
            f"capability {cap}; the kernels are built for sm_90a {CAPABILITY}"
        )
    return torch.device("cuda", index)
