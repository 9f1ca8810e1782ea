"""Plain PyTorch version of decode_attention (``repro/kernels/decode_attention/ref.py``).

The CPU path of the wrapper and the yardstick the CUDA kernel is held to
on the card. ``decode_attention_ref`` works on the kernel's folded layout;
``decode_attention_plain`` takes the model's layout and folds it as the
reference's ``ops.decode_attention`` does.
"""

from __future__ import annotations

import torch

__all__ = ["decode_attention_plain", "decode_attention_ref"]


def decode_attention_ref(q, k, v, mask, softcap=0.0):
    """q: (BKV, G, D); k/v: (BKV, S, D); mask: (BKV, S) bool -> (BKV, G, D).

    f32 scores scaled by ``d**-0.5`` (capped at ``softcap * tanh(s /
    softcap)`` when ``softcap > 0``, as the reference's decode applies
    ``logit_softcap``, ``repro/models/attention.py:282-285``), masked slots
    at -1e30, softmax, then masked probabilities zeroed (a fully masked row
    gives zeros), PV in f32.
    """
    d = q.shape[-1]
    s = torch.einsum("bgd,bsd->bgs", q.float(), k.float()) * (d**-0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    m = mask[:, None, :]
    s = torch.where(m, s, -1e30)
    p = torch.softmax(s, dim=-1)
    p = torch.where(m, p, 0.0)
    return torch.einsum("bgs,bsd->bgd", p, v.float()).to(q.dtype)


def decode_attention_plain(q, cache_k, cache_v, mask, softcap=0.0):
    """q: (B, H, D); cache_k/v: (B, S, KVH, D); mask: (B, S) bool -> (B, H, D).

    Folds to the kernel layout (q (B·KVH, G, D), cache (B·KVH, S, D), mask
    (B·KVH, S)) and runs :func:`decode_attention_ref` with ``softcap``.
    """
    b, h, d = q.shape
    s, kvh = cache_k.shape[1], cache_k.shape[2]
    qg = q.reshape(b * kvh, h // kvh, d)

    def fold(t):
        return t.transpose(1, 2).reshape(b * kvh, s, d)

    m = mask[:, None, :].expand(b, kvh, s).reshape(b * kvh, s)
    return decode_attention_ref(qg, fold(cache_k), fold(cache_v), m, softcap).reshape(q.shape)
