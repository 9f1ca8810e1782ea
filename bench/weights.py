"""Weights made from the run's seed, on the device, one draw a leaf.

Both sides are given the same numbers: the program its leaves in the
type it serves them in (bf16), the reference the same values widened to
f32. A leaf is drawn by a ``torch.Generator`` on the device seeded from
``(seed, leaf index)``, so it can be drawn again on its own, identically,
after the program has changed it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["draw", "leaf_seed"]


def leaf_seed(seed: int, index: int) -> int:
    return int(np.random.SeedSequence((seed, 17, index)).generate_state(1, np.uint64)[0]
               & ((1 << 63) - 1))


def draw(spec: tuple, seed: int, index: int, device, dtype) -> torch.Tensor:
    """One leaf of ``spec = (shape, init)`` in ``dtype``, rounded through
    bf16 (the type the program is given), on ``device``."""
    shape, init = spec
    kind = init[0]
    if kind == "zeros":
        out = torch.zeros(shape, device=device)
    elif kind == "ones":
        out = torch.ones(shape, device=device)
    elif kind == "a_log":
        heads = shape[-1]
        row = torch.log(torch.linspace(1.0, 16.0, heads, device=device))
        out = row.expand(shape).contiguous()
    else:
        gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
        std = init[1] if kind == "normal" else 1.0 / math.sqrt(max(init[1], 1))
        out = torch.randn(shape, generator=gen, device=device) * std
    return out.to(torch.bfloat16).to(dtype)
