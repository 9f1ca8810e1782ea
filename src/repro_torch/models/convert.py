"""The weights bridge between the reference's values tree and the port.

A tree is the reference's ``values`` structure with numpy leaves (what
``np.asarray`` of the JAX arrays gives, or what a checkpoint holds). Both
directions are bit-exact. bfloat16 needs care, and no ``ml_dtypes``
(the port may not import it): a JAX bf16 leaf arrives as an
``ml_dtypes.bfloat16`` array, a checkpointed one as raw ``|V2`` bytes;
either is reinterpreted as 16-bit integers and viewed as
``torch.bfloat16``. On the way back a bf16 tensor leaves as its ``uint16`` bits.
A hybrid tree moves the same way: its ``shared_attn`` block is one more
subtree, and the ``{}`` placeholder at each shared site has no leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import flatten_tree

__all__ = ["from_numpy", "load_values", "to_numpy", "values_to_numpy"]


def _is_bf16_bits(arr: np.ndarray) -> bool:
    return (arr.dtype.itemsize == 2 and arr.dtype.kind == "V") or arr.dtype.name == "bfloat16"


def from_numpy(arr) -> torch.Tensor:
    """One numpy leaf -> CPU tensor with the same bits (bf16 included)."""
    arr = np.array(arr, order="C")  # a writable copy, 0-d kept 0-d
    if _is_bf16_bits(arr):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor -> numpy on the host; bf16 as its ``uint16`` bits."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


@torch.no_grad()
def load_values(model, values) -> None:
    """Copy a reference values tree (numpy leaves) into ``model``'s
    parameters, bit for bit. Paths, shapes and dtypes must all match."""
    src = flatten_tree(values)
    dst = flatten_tree(model.values())
    if set(src) != set(dst):
        raise KeyError(f"tree paths differ: missing {sorted(set(dst) - set(src))}, "
                       f"unexpected {sorted(set(src) - set(dst))}")
    for path, p in dst.items():
        t = from_numpy(src[path])
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"{path}: {tuple(t.shape)} {t.dtype} does not match "
                             f"the parameter's {tuple(p.shape)} {p.dtype}")
        p.copy_(t)


def values_to_numpy(model) -> dict:
    """``model``'s parameters as the reference's values tree of numpy
    leaves (bf16 as ``uint16`` bits: view them with the JAX side's
    bfloat16 dtype to get the JAX array back)."""

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return to_numpy(tree)

    return walk(model.values())
