"""Plain PyTorch building blocks of the references, in float32.

Nothing here imports the program under test. The equations are the ones
the configurations' files name: RMSNorm with a ``(1 + scale)`` gain,
half-split rotary embeddings, softmax attention, a SwiGLU feed-forward,
masked cross entropy with a z-loss, and AdamW with a warm-up schedule and
clipping by the global norm.

``Precision`` says how a matrix product is computed. ``"f32"`` is the
reference itself (TF32 is switched off by whoever runs it). ``"fp8"`` is
the control: each operand of every product is rounded to float8 e4m3 with
one scale a tensor before an f32 product, the step below the bfloat16 that
the configurations state.
"""

from __future__ import annotations

import math

import torch

__all__ = ["Precision", "adamw_step", "apply_rope", "attention", "clip_by_global_norm",
           "lm_loss_sums", "rms_norm", "rope_tables", "swiglu"]

_FP8_MAX = 448.0  # largest finite float8 e4m3 value


class Precision:
    """How :meth:`mm` and :meth:`q` round matrix-product operands."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"precision must be f32 or fp8, got {mode!r}")
        self.mode = mode

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as an operand of a product: itself in f32, rounded to
        float8 e4m3 under one per-tensor scale in fp8 (differentiable as
        the identity, as a quantised training step's straight-through
        estimate is)."""
        if self.mode == "f32":
            return t
        scale = t.detach().abs().amax().clamp(min=1e-30) / _FP8_MAX
        r = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return t + (r - t.detach())

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def einsum(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *(self.q(o) for o in ops))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale)


def rope_tables(seq_len: int, head_dim: int, theta: float, device) -> tuple:
    """(sin, cos), each (S, head_dim // 2): angle ``pos / theta^(2i/D)``."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64) / half))
    pos = torch.arange(seq_len, dtype=torch.float64)
    ang = (pos[:, None] * inv.to(torch.float32).to(torch.float64)[None, :]).to(torch.float32)
    return torch.sin(ang).to(device), torch.cos(ang).to(device)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D): the first and second halves of each head rotated as
    pairs; a last odd lane is left as it is."""
    half = sin.shape[-1]
    s, c = sin[:, None, :], cos[:, None, :]
    x1, x2, rest = x[..., :half], x[..., half:2 * half], x[..., 2 * half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s, rest], dim=-1)


def attention(q, k, v, *, causal: bool, window: int, prec: Precision) -> torch.Tensor:
    """Softmax attention, q/k/v (B, S, H, D) with as many K/V heads as
    query heads; ``window`` 0 for none. Returns (B, S, H, D)."""
    s = q.shape[1]
    logits = prec.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    allowed = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        allowed &= kpos <= qpos
    if window:
        allowed &= kpos > qpos - window
    logits = logits.masked_fill(~allowed, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return prec.einsum("bhqk,bkhd->bqhd", probs, v)


def swiglu(x, w_gate, w_up, w_out, prec: Precision) -> torch.Tensor:
    h = torch.nn.functional.silu(prec.mm(x, w_gate)) * prec.mm(x, w_up)
    return prec.mm(h, w_out)


def lm_loss_sums(logits, targets, mask) -> tuple:
    """Masked sums of the token cross entropy and of logsumexp², so that a
    batch taken in blocks of rows adds up to the whole batch's loss."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return ((logz - gold) * mask).sum(), (logz * logz * mask).sum()


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}


def learning_rate(step: int, hp: dict) -> float:
    """Linear warm-up over ``warmup`` steps, then a cosine to ``total``
    with a floor of a tenth."""
    lr, warm, total = hp["learning_rate"], hp["warmup"], hp["total_steps"]
    if step < warm:
        return lr * (step + 1) / warm
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return max(lr * 0.5 * (1 + math.cos(math.pi * prog)), lr * 0.1)


@torch.no_grad()
def adamw_step(params: dict, grads: dict, m: dict, v: dict, step: int, hp: dict) -> None:
    """One AdamW update in place, ``step`` counted from 0; decoupled weight
    decay on every tensor of rank 2 or more."""
    b1, b2, eps, wd = hp["b1"], hp["b2"], hp["eps"], hp["weight_decay"]
    lr = learning_rate(step, hp)
    t = step + 1
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    for k, g in grads.items():
        m[k].mul_(b1).add_((1 - b1) * g)
        v[k].mul_(b2).add_((1 - b2) * g * g)
        u = (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps)
        p = params[k]
        if p.ndim >= 2:
            u = u + wd * p
        p.sub_(lr * u)
