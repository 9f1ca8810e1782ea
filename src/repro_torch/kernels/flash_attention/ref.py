"""Plain PyTorch version of flash_attention (``repro/kernels/flash_attention/ref.py``).

The CPU path of the wrappers and the yardstick the CUDA kernel is held to
on the card: naive full-matrix attention, f32 softmax, output in
``q.dtype``. ``softcap > 0`` caps the scaled f32 logits at ``softcap *
tanh(s / softcap)`` before the mask, where the reference's attention
applies ``logit_softcap`` (``repro/models/attention.py:64-67``).
"""

from __future__ import annotations

import torch

__all__ = ["attention_gqa_ref", "attention_ref"]


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q/k/v: (BH, S, D). Masked logits at -1e30; a fully masked row
    (possible with a window and no causal mask) gives zeros, like the
    kernel."""
    s, d = q.shape[1], q.shape[2]
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (d**-0.5)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask.any(dim=1)[None, :, None], probs, 0.0)
    return torch.einsum("bqk,bkd->bqd", probs, v.float()).to(q.dtype)


def attention_gqa_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """(B, S, H, D) x (B, S, KVH, D) -> (B, S, H, D): K/V expanded over each
    kv head's query group (``repeat_interleave``, as ``jnp.repeat``), heads
    folded into the batch, :func:`attention_ref`, unfolded."""
    b, s, h, d = q.shape
    groups = h // k.shape[2]
    k = torch.repeat_interleave(k, groups, dim=2)
    v = torch.repeat_interleave(v, groups, dim=2)

    def fold(t):
        return t.transpose(1, 2).reshape(b * h, s, d)

    out = attention_ref(fold(q), fold(k), fold(v), causal=causal, window=window,
                        softcap=softcap)
    return out.reshape(b, h, s, d).transpose(1, 2)
