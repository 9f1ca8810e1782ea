"""Shared model machinery: norms, RoPE, init (``repro/models/common.py``).

The numerics follow the reference op for op: RMSNorm in f32 with a
``(1 + scale)`` gain, half-split RoPE from numpy-float32 frequencies with
the tail lane of an odd head dim left unrotated. Init draws from an
explicit ``torch.Generator``; it cannot reproduce JAX's PRNG bits, so the
tests move weights across with :mod:`repro_torch.models.convert`.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = [
    "apply_rope",
    "flatten_tree",
    "make_rope",
    "normal_init",
    "rms_norm",
    "scaled_init",
]


def flatten_tree(tree, prefix: str = "", is_leaf=None) -> dict:
    """Nested dict/list tree -> {"a/b/0/c": leaf} in the reference's leaf
    order (dict keys sorted, lists in index order, as ``jax.tree`` does).
    ``is_leaf(node)`` true stops the descent there (an axes tuple)."""
    out: dict = {}
    if is_leaf is not None and is_leaf(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else k, is_leaf))
    return out


def normal_init(gen: torch.Generator, shape, dtype, stddev=0.02) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device) * stddev).to(dtype)


def scaled_init(gen: torch.Generator, shape, dtype, fan_in=None) -> torch.Tensor:
    """Fan-in scaled normal init (1/sqrt(fan_in)), drawn in f32."""
    fan_in = fan_in if fan_in is not None else shape[0]
    return (
        torch.randn(shape, generator=gen, device=gen.device) / math.sqrt(max(fan_in, 1))
    ).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32, result cast back to x.dtype (LLaMA convention)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """The reference's numpy-float32 RoPE frequencies on ``device``, made
    once: a copy from host memory on every call waits for the card, once
    per layer of every decode step. Made outside inference mode, so that a
    training step may use it after a serving step has."""
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    with torch.inference_mode(False):
        return torch.from_numpy(np.asarray(freqs, np.float32)).to(device)


def make_rope(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """(sin, cos) tables for the given positions; fp32."""
    freqs = _rope_freqs(head_dim // 2, float(theta), positions.device)
    angles = positions.float()[..., None] * freqs  # (..., half)
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1 sin).

    x: (..., S, H, D); sin/cos: (..., S, D/2) broadcast over heads.
    Odd head_dims leave the last lane unrotated.
    """
    half = sin.shape[-1]
    sin = sin[..., None, :]  # add head axis
    cos = cos[..., None, :]
    x1 = x[..., :half]
    x2 = x[..., half : 2 * half]
    rest = x[..., 2 * half :]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    out = torch.cat([y1, y2] + ([rest] if rest.shape[-1] else []), dim=-1)
    return out.to(x.dtype)
