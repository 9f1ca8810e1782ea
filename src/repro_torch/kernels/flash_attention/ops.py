"""The flash-attention wrappers (``repro/kernels/flash_attention/ops.py``).

On CPU tensors they run the plain version (``ref.py``), which autograd
differentiates; on CUDA tensors they launch the kernels in
``flash_attention.cu`` on the current stream, or raise. Inputs that
require grad (with grad enabled) go through :class:`_FlashTrain`, whose
forward is the bf16 kernel's training instantiation (it also stores each
row's log-sum-exp) and whose backward is the bf16 backward kernel; f32
CUDA inputs that require grad raise, as there is no f32 backward.
``flash_attention.launches`` counts kernel launches from either wrapper,
a backward as one, and only those. ``softcap > 0`` caps the scaled logits
at ``softcap * tanh(s / softcap)`` before the mask (the reference's
``logit_softcap``); 0 launches the uncapped instantiation.

The bf16 kernels' persistent blocks take work items from int32 counters
that each launch leaves at 0 (``common.zeroed_counters``), the forward's
and the backward's apart.

``train_calls`` is the tracer's host tally ``attn.flash_calls``
(``obs/tracer.py``): the training route's launches and their FLOPs
(:func:`attention_flops`), which each ``train.step`` span carries for its
step. A forward launch is ``4 B H D P`` FLOP, a backward ``10 B H D P``
(S, dP, dV, dK, dQ), with P the (query, key) pairs the mask keeps and D
the true head dim.
"""

from __future__ import annotations

import ctypes

import torch

from ...obs.tracer import host_tally
from .. import build
from ..common import count_launch, resolve_device, zeroed_counters
from .ref import attention_gqa_ref, attention_ref

__all__ = ["F32_HEAD_DIMS", "HEAD_DIMS", "attention_flops", "flash_attention",
           "flash_attention_gqa", "kept_pairs", "train_calls"]

#: Head dims the bf16 kernels (forward, training forward, backward) are
#: instantiated for; 80 runs in 128-column tiles.
HEAD_DIMS = (32, 64, 80, 128)
#: Head dims the f32 forward is instantiated for.
F32_HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: The training route's launches so far: forward and backward counts and
#: their FLOPs (host integers, added when a launch is queued or captured).
train_calls = host_tally("attn.flash_calls", "forward", "backward", "forward_flops",
                         "backward_flops", "flops")


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        # Pointers and the stream as c_void_p: never cut to 32 bits.
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float]
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        bwd = lib.flash_attention_bwd_launch
        bwd.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_float]
                        + [ctypes.c_void_p])
        bwd.restype = ctypes.c_int
        lib.flash_attention_bwd_workspace.argtypes = [ctypes.c_int] * 5
        lib.flash_attention_bwd_workspace.restype = ctypes.c_longlong
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def kept_pairs(s: int, causal: bool, window: int) -> int:
    """The (query, key) pairs of an S x S mask that attend: S^2, S(S+1)/2
    causal, fewer with a window (key j valid for query i when j <= i if
    causal and j > i - window if windowed)."""
    hi = s * (s - 1) // 2 if causal else s * (s - 1)  # sum over i of the last valid key
    lo = (s - window) * (s - window + 1) // 2 if window and s > window else 0  # of the first
    return hi - lo + s


def attention_flops(q_shape, causal: bool, window: int, *, backward: bool = False) -> int:
    """FLOPs of one launch on q of ``q_shape`` (B, S, H, D): ``4 B H D P``
    forward, ``10 B H D P`` backward."""
    b, s, h, d = q_shape
    return (10 if backward else 4) * b * h * d * kept_pairs(s, causal, window)


def _check(q, k, v, window, softcap) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}; q, k and v must all be float32 or "
                            "all bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not 0.0 <= softcap < float("inf"):
        raise ValueError(f"softcap must be a finite number >= 0, got {softcap}")


def _checked_card(q, k, v) -> torch.device:
    device = q.device
    resolve_device(device)  # raises unless a capability-9.0 card (checked once per card)
    d = q.shape[3]
    dims = HEAD_DIMS if q.dtype == torch.bfloat16 else F32_HEAD_DIMS
    if d not in dims:
        raise ValueError(f"head dim {d} is not one the {q.dtype} kernel is built for {dims}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):  # TMA's base-address rule
        raise ValueError("q, k and v must be 16-byte aligned")
    return device


def _raise(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.flash_attention_error_string(rc).decode())


def _launch(q, k, v, causal: bool, window: int, softcap: float, *, lse: bool = False):
    """q (B, S, H, D), k/v (B, S, KVH, D) on the card -> (B, S, H, D), and
    with ``lse`` the rows' log-sum-exp (B, H, S) f32 (bf16 only)."""
    device = _checked_card(q, k, v)
    b, s, h, d = q.shape
    kvh = k.shape[2]
    out = torch.empty_like(q)
    lse_t = torch.empty((b, h, s), dtype=torch.float32, device=device) if lse else None
    sched = zeroed_counters("flash_attention", device, 2) if q.dtype == torch.bfloat16 else None
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if sched is None else sched.data_ptr(), b, h, kvh, s, d,
            int(bool(causal)), int(window), _DTYPES[q.dtype], float(softcap),
            None if lse_t is None else lse_t.data_ptr(), stream,
        )
    _raise(lib, rc, "flash_attention")
    count_launch(flash_attention)
    return (out, lse_t) if lse else out


def _launch_bwd(q, k, v, out, lse, dout, causal: bool, window: int, softcap: float):
    """The backward on the card: (dq, dk, dv) shaped as (q, k, v)."""
    device = q.device
    b, s, h, d = q.shape
    kvh = k.shape[2]
    lib = _lib()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ws = torch.empty(lib.flash_attention_bwd_workspace(b, h, kvh, s, d), dtype=torch.float32,
                     device=device)
    sched = zeroed_counters("flash_attention_bwd", device, 2)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.data_ptr(),
            sched.data_ptr(), b, h, kvh, s, d, int(bool(causal)), int(window), float(softcap),
            stream,
        )
    _raise(lib, rc, "flash_attention backward")
    count_launch(flash_attention)
    return dq, dk, dv


def _tally(kind: str, q_shape, causal: bool, window: int) -> None:
    flops = attention_flops(q_shape, causal, window, backward=kind == "backward")
    train_calls[kind] += 1
    train_calls[f"{kind}_flops"] += flops
    train_calls["flops"] += flops


class _FlashTrain(torch.autograd.Function):
    """Flash attention with a gradient, on bf16 CUDA tensors: the forward
    saves q, k, v, the output and the rows' log-sum-exp; the backward
    launches the backward kernel on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = _launch(q, k, v, causal, window, softcap, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, softcap)
        _tally("forward", q.shape, causal, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        dq, dk, dv = _launch_bwd(q, k, v, out, lse, dout.contiguous(), causal, window, softcap)
        _tally("backward", q.shape, causal, window)
        return dq, dk, dv, None, None, None


def _attend(q, k, v, causal, window, softcap):
    """The card's route: with a gradient to keep, :class:`_FlashTrain`
    (bf16 only), else the forward kernel."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention's backward kernel is bf16 only; got {q.dtype} "
                            "inputs that require grad")
        return _FlashTrain.apply(q, k, v, bool(causal), int(window), float(softcap))
    return _launch(q, k, v, causal, window, softcap)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """(BH, S, D) attention, causal and/or sliding-window, logits capped at
    ``softcap`` when it is > 0; any S."""
    _check(q, k, v, window, softcap)
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v of one (BH, S, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    return _attend(q[:, :, None], k[:, :, None], v[:, :, None], causal, window,
                   softcap)[:, :, 0]


def flash_attention_gqa(q, k, v, *, causal=True, window=0, softcap=0.0):
    """(B, S, H, D) x (B, S, KVH, D) GQA attention -> (B, S, H, D).

    Query head ``h`` attends with kv head ``h // (H // KVH)``, as the
    reference's ``jnp.repeat`` expand gives; the kernels read that head in
    place instead of expanding it in memory, and the backward sums a kv
    head's gradient over its query heads. ``softcap`` as
    :func:`flash_attention`'s.
    """
    _check(q, k, v, window, softcap)
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, S, H, D) and k/v (B, S, KVH, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of {k.shape[2]} kv heads")
    if q.device.type == "cpu":
        return attention_gqa_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    return _attend(q, k, v, causal, window, softcap)


flash_attention.launches = flash_attention.captured_launches = 0
