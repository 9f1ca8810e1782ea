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
step. A forward launch is ``2 B H P (D + Dv)`` FLOP, a backward ``2 B H P
(3 D + 2 Dv)`` (S, dK, dQ at the query / key width D; dP, dV at the value
width Dv), with P the (query, key) pairs the mask keeps: ``4 B H D P`` and
``10 B H D P`` when the widths are equal.

:func:`flash_attention_mla` is multi-head latent attention's core: q and
k 192 wide (128 + a 64-wide rotary part), v 128, every head its own K and
V, and the softmax at a scale the caller gives (YaRN's, not ``D**-0.5``).
On the card it takes the same route at the kernels' (192, 128)
instantiation, bf16 and training only (a forward that keeps the
log-sum-exp, with or without a gradient to keep, and its backward); any
other card call raises. Its launches go into their own tally,
``attn.mla_calls`` (``mla_calls``), with the same counts.
"""

from __future__ import annotations

import ctypes

import torch

from ...obs.tracer import host_tally
from .. import build
from ..common import count_launch, resolve_device, zeroed_counters
from .ref import attention_gqa_ref, attention_ref

__all__ = ["F32_HEAD_DIMS", "HEAD_DIMS", "MLA_DIMS", "attention_flops", "flash_attention",
           "flash_attention_gqa", "flash_attention_mla", "kept_pairs", "mla_calls", "train_calls"]

#: Head dims the bf16 kernels (forward, training forward, backward) are
#: instantiated for; 80 runs in 128-column tiles.
HEAD_DIMS = (32, 64, 80, 128)
#: Head dims the f32 forward is instantiated for.
F32_HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: The (query / key, value) widths of the bf16 training kernels' one
#: instantiation with unequal widths (multi-head latent attention's).
MLA_DIMS = (192, 128)

#: The training route's launches so far: forward and backward counts and
#: their FLOPs (host integers, added when a launch is queued or captured).
train_calls = host_tally("attn.flash_calls", "forward", "backward", "forward_flops",
                         "backward_flops", "flops")
#: The same for the (192, 128) launches.
mla_calls = host_tally("attn.mla_calls", "forward", "backward", "forward_flops",
                       "backward_flops", "flops")


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        # Pointers and the stream as c_void_p: never cut to 32 bits.
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        bwd = lib.flash_attention_bwd_launch
        bwd.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
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


def attention_flops(q_shape, causal: bool, window: int, *, dv: int | None = None,
                    backward: bool = False) -> int:
    """FLOPs of one launch on q of ``q_shape`` (B, S, H, D) and values ``dv``
    wide (None: D): ``2 B H P (D + Dv)`` forward, ``2 B H P (3 D + 2 Dv)``
    backward."""
    b, s, h, d = q_shape
    dv = d if dv is None else dv
    width = 3 * d + 2 * dv if backward else d + dv
    return 2 * b * h * kept_pairs(s, causal, window) * width


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
    d, dv = q.shape[3], v.shape[3]
    dims = HEAD_DIMS if q.dtype == torch.bfloat16 else F32_HEAD_DIMS
    if (d, dv) != MLA_DIMS or q.dtype != torch.bfloat16:
        if d not in dims:
            raise ValueError(f"head dim {d} is not one the {q.dtype} kernel is built for {dims}")
        if dv != d:
            raise ValueError(f"value width {dv} differs from the head dim {d}; the kernels take "
                             f"unequal widths only at {MLA_DIMS}, bf16")
    if any(t.data_ptr() % 16 for t in (q, k, v)):  # TMA's base-address rule
        raise ValueError("q, k and v must be 16-byte aligned")
    return device


def _raise(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.flash_attention_error_string(rc).decode())


def _launch(q, k, v, causal: bool, window: int, softcap: float, *, lse: bool = False,
            scale: float | None = None):
    """q (B, S, H, D), k (B, S, KVH, D), v (B, S, KVH, Dv) on the card -> (B,
    S, H, Dv), and with ``lse`` the rows' log-sum-exp (B, H, S) f32 (bf16
    only). ``scale`` None is D^-0.5; the (192, 128) kernels take another,
    and always store the log-sum-exp."""
    device = _checked_card(q, k, v)
    b, s, h, d = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    out = q.new_empty((b, s, h, dv))
    keep = lse or (d, dv) == MLA_DIMS
    lse_t = torch.empty((b, h, s), dtype=torch.float32, device=device) if keep else None
    sched = zeroed_counters("flash_attention", device, 2) if q.dtype == torch.bfloat16 else None
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if sched is None else sched.data_ptr(), b, h, kvh, s, d, dv,
            int(bool(causal)), int(window), _DTYPES[q.dtype], float(softcap),
            0.0 if scale is None else float(scale),
            None if lse_t is None else lse_t.data_ptr(), stream,
        )
    _raise(lib, rc, "flash_attention")
    count_launch(flash_attention)
    return (out, lse_t) if lse else out


def _launch_bwd(q, k, v, out, lse, dout, causal: bool, window: int, softcap: float,
                scale: float | None = None):
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
            sched.data_ptr(), b, h, kvh, s, d, v.shape[3], int(bool(causal)), int(window),
            float(softcap), 0.0 if scale is None else float(scale), stream,
        )
    _raise(lib, rc, "flash_attention backward")
    count_launch(flash_attention)
    return dq, dk, dv


def _tally(kind: str, q_shape, causal: bool, window: int, dv: int | None = None) -> None:
    """A training launch into ``attn.flash_calls``, or at (192, 128) into
    ``attn.mla_calls``."""
    flops = attention_flops(q_shape, causal, window, dv=dv, backward=kind == "backward")
    tally = mla_calls if (q_shape[3], dv) == MLA_DIMS else train_calls
    tally[kind] += 1
    tally[f"{kind}_flops"] += flops
    tally["flops"] += flops


class _FlashTrain(torch.autograd.Function):
    """Flash attention with a gradient, on bf16 CUDA tensors: the forward
    saves q, k, v, the output and the rows' log-sum-exp; the backward
    launches the backward kernel on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        out, lse = _launch(q, k, v, causal, window, softcap, lse=True, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, softcap, scale)
        _tally("forward", q.shape, causal, window, v.shape[3])
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap, scale = ctx.mask
        dq, dk, dv = _launch_bwd(q, k, v, out, lse, dout.contiguous(), causal, window, softcap,
                                 scale)
        _tally("backward", q.shape, causal, window, v.shape[3])
        return dq, dk, dv, None, None, None, None


def _attend(q, k, v, causal, window, softcap, scale=None):
    """The card's route: with a gradient to keep, :class:`_FlashTrain`
    (bf16 only), else the forward kernel."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention's backward kernel is bf16 only; got {q.dtype} "
                            "inputs that require grad")
        return _FlashTrain.apply(q, k, v, bool(causal), int(window), float(softcap), scale)
    return _launch(q, k, v, causal, window, softcap, scale=scale)


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


def flash_attention_mla(q, k, v, *, scale: float, causal: bool = True):
    """Multi-head latent attention's core: q and k (B, S, H, Dqk), v (B, S,
    H, Dv) -> softmax(``scale`` q kᵀ) v, (B, S, H, Dv), causal or not.

    CPU tensors run the plain version at any widths (autograd
    differentiates it). On the card the kernels take bf16 plain tensors of
    the widths :data:`MLA_DIMS`, 16-byte aligned; anything else raises (an
    f32 call, a DTensor, another width), as nothing falls back. With a
    gradient to keep the call is :class:`_FlashTrain`; without one the same
    training forward runs and its log-sum-exp is dropped."""
    _check(q, k, v, 0, 0.0)
    if q.ndim != 4 or k.shape != q.shape or v.ndim != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"expected q and k (B, S, H, Dqk) and v (B, S, H, Dv), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not 0.0 < scale < float("inf"):
        raise ValueError(f"scale must be a finite number > 0, got {scale}")
    if any(type(t) is not torch.Tensor for t in (q, k, v)):
        raise TypeError(f"flash_attention_mla takes plain tensors, got {type(q).__name__}")
    b, s, h, d = q.shape
    if q.device.type == "cpu":
        def fold(t):
            return t.transpose(1, 2).reshape(b * h, s, t.shape[3])

        out = attention_ref(fold(q), fold(k), fold(v), causal=causal, scale=scale)
        return out.reshape(b, h, s, v.shape[3]).transpose(1, 2)
    if (d, v.shape[3]) != MLA_DIMS:
        raise ValueError(f"widths (q/k {d}, v {v.shape[3]}) are not the ones the kernels take "
                         f"at a scale of the caller's {MLA_DIMS}")
    return _attend(q, k, v, causal, 0, 0.0, float(scale))
