"""The fused global-norm clip and AdamW wrapper (no counterpart in
``repro/kernels``: the reference's update is jnp code that XLA fuses).

:func:`clip_adamw_` runs ``optim/optimizers.py``'s ``clip_by_global_norm``
and AdamW's update with an f32 master over a whole tree of CUDA tensors as
two launches of ``fused_adamw.cu``: the sum of squares of every gradient
(the norm and the clip's scale stay on the card), then the update of every
leaf. The plain version is that loop, which every other input takes
(:func:`takes` says which); this wrapper raises on what the kernels do not
take (a strided leaf, a leaf off the card, another dtype) rather than fall
back. ``clip_adamw_.launches`` counts the kernels' launches, and only
those.

``update_bytes`` is the tracer's host tally ``optim.update_bytes``
(``obs/tracer.py``): the launches and the bytes they must move
(:func:`step_bytes`), which each ``train.step`` span carries for its step.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.distributed.tensor import DTensor

from ...obs.tracer import host_tally
from .. import build
from ..common import checked_cuda, count_launch, zeroed_counters

__all__ = ["NORM_BLOCKS", "card_leaf", "clip_adamw_", "step_bytes", "takes", "update_bytes"]

#: The norm kernel's fixed grid: the blocks whose partial sums make the norm.
NORM_BLOCKS = 1024
_GRAD_BF16, _PARAM_BF16, _DECAY = 1, 2, 4
_DTYPES = (torch.bfloat16, torch.float32)

#: The launches so far and the bytes they must move (host integers, added
#: when a launch is queued or captured).
update_bytes = host_tally("optim.update_bytes", "launches", "bytes")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("fused_adamw")
    lib.fused_adamw_max_leaves.restype = ctypes.c_int
    # Pointers and the stream as c_void_p: never cut to 32 bits.
    lib.fused_adamw_norm_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p]
        + [ctypes.c_float] + [ctypes.c_void_p] * 2)
    lib.fused_adamw_norm_launch.restype = ctypes.c_int
    lib.fused_adamw_update_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_float] * 6 + [ctypes.c_void_p])
    lib.fused_adamw_update_launch.restype = ctypes.c_int
    lib.fused_adamw_error_string.argtypes = [ctypes.c_int]
    lib.fused_adamw_error_string.restype = ctypes.c_char_p
    return lib


def card_leaf(kind: type, device: str) -> bool:
    """Whether a leaf of tensor type ``kind`` on device type ``device`` goes
    to the kernels: a CUDA tensor that is not a DTensor (the sharded path,
    whose update its collectives make). The kernels then take it or raise."""
    return device == "cuda" and not issubclass(kind, DTensor)


def takes(*trees: dict) -> bool:
    """Whether these ``{path: tensor}`` trees (gradients, parameters,
    state) go to the kernels: every leaf :func:`card_leaf`. CPU, meta and
    DTensor leaves take the loop."""
    leaves = [t for tree in trees for t in tree.values()]
    return bool(leaves) and all(card_leaf(type(t), t.device.type) for t in leaves)


def step_bytes(grads: dict, params: dict) -> int:
    """Bytes the two kernels must move: the norm reads each gradient once;
    the update reads g, m, v and the master and writes m, v, the master and
    the parameter (30 bytes a parameter for bf16 gradients and parameters)."""
    return sum(g.numel() * (2 * g.element_size() + 6 * 4 + params[k].element_size())
               for k, g in grads.items())


def _check(grads: dict, m: dict, v: dict, master: dict, params: dict) -> torch.device:
    if not grads:
        raise ValueError("clip_adamw_ needs at least one leaf")
    device = next(iter(grads.values())).device
    for k, g in grads.items():
        leaves = {"grad": g, "m": m[k], "v": v[k], "master": master[k], "param": params[k]}
        for name, t in leaves.items():
            if type(t) not in (torch.Tensor, torch.nn.Parameter) or t.device.type != "cuda":
                raise ValueError(f"{k} {name}: the kernels take plain CUDA tensors, got "
                                 f"{type(t).__name__} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{k} {name}: the kernels take contiguous tensors, got "
                                 f"strides {t.stride()} for shape {tuple(t.shape)}")
            if t.device != device:
                raise ValueError(f"{k} {name} is on {t.device}, the first gradient on {device}")
            if t.shape != g.shape:
                raise ValueError(f"{k} {name} has shape {tuple(t.shape)}, its gradient "
                                 f"{tuple(g.shape)}")
        if g.dtype not in _DTYPES or params[k].dtype not in _DTYPES:
            raise TypeError(f"{k}: gradients and parameters must be bfloat16 or float32, got "
                            f"{g.dtype} and {params[k].dtype}")
        if any(t.dtype != torch.float32 for t in (m[k], v[k], master[k])):
            raise TypeError(f"{k}: m, v and the master must be float32")
    return device


def _scalar(name: str, t, device) -> int:
    if not (isinstance(t, torch.Tensor) and t.dtype == torch.float32 and t.numel() == 1
            and t.device == device):
        raise ValueError(f"{name} must be a one-element float32 tensor on {device}")
    return t.data_ptr()


def _raise(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: " + lib.fused_adamw_error_string(rc).decode())


@torch.no_grad()
def clip_adamw_(grads: dict, m: dict, v: dict, master: dict, params: dict, *, lr, c1, c2,
                b1: float, b2: float, eps: float, weight_decay: float, max_norm: float):
    """Clip ``grads`` by their global norm and apply AdamW in place.

    Every argument tree is ``{path: tensor}`` over the gradients' paths; m,
    v and the master are f32, gradients and parameters bf16 or f32. ``lr``,
    ``c1`` and ``c2`` are 0-d f32 device tensors (the step's learning rate
    and bias corrections), read by the kernel at every run. Returns the
    global norm, a 0-d f32 device tensor; the gradients are scaled by
    min(1, max_norm / max(norm, 1e-9)), rounded to their dtype, as
    ``clip_by_global_norm`` does. Weight decay applies to leaves of rank >= 2.
    """
    device = _check(grads, m, v, master, params)
    index = device.index if device.index is not None else torch.cuda.current_device()
    checked_cuda(index)  # raises unless a capability-9.0 card (checked once per card)
    keys = list(grads)
    count = len(keys)
    lib = _lib()

    def ptrs(tree):
        return (ctypes.c_void_p * count)(*(tree[k].data_ptr() for k in keys))

    g_ptrs = ptrs(grads)
    sizes = (ctypes.c_longlong * count)(*(grads[k].numel() for k in keys))
    flags = (ctypes.c_int * count)(*(
        (_GRAD_BF16 if grads[k].dtype == torch.bfloat16 else 0)
        | (_PARAM_BF16 if params[k].dtype == torch.bfloat16 else 0)
        | (_DECAY if params[k].ndim >= 2 else 0) for k in keys))
    scalars = [_scalar(name, t, device) for name, t in (("lr", lr), ("c1", c1), ("c2", c2))]
    n_launches = -(-count // lib.fused_adamw_max_leaves())  # of each kernel
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(device).cuda_stream
        partials = torch.empty(n_launches * NORM_BLOCKS, dtype=torch.float64, device=device)
        out = torch.empty(2, dtype=torch.float32, device=device)  # norm, scale
        done = zeroed_counters("fused_adamw", device, 1)
        _raise(lib, lib.fused_adamw_norm_launch(
            count, g_ptrs, sizes, flags, partials.data_ptr(), NORM_BLOCKS,
            done.data_ptr(), float(max_norm), out.data_ptr(), stream), "optim_norm_kernel")
        _raise(lib, lib.fused_adamw_update_launch(
            count, g_ptrs, ptrs(m), ptrs(v), ptrs(master), ptrs(params), sizes, flags,
            out[1].data_ptr(), *scalars, b1, 1 - b1, b2, 1 - b2, eps, weight_decay, stream),
            "optim_adamw_kernel")
    for _ in range(2 * n_launches):
        count_launch(clip_adamw_)
    update_bytes["launches"] += 2 * n_launches
    update_bytes["bytes"] += step_bytes(grads, params)
    return out[0]


clip_adamw_.launches = clip_adamw_.captured_launches = 0
