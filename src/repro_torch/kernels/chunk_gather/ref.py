"""Plain PyTorch versions of chunk_gather and chunk_gather_train
(``repro/kernels/chunk_gather/ref.py``).

The CPU path of the wrappers and the yardstick the CUDA kernels are held
to, exactly, on the card.
"""

from __future__ import annotations

import torch

__all__ = ["chunk_gather_ref", "chunk_gather_train_ref"]


def chunk_gather_ref(chunk_tokens, record_lens, indices, *, pad_id=0):
    """tokens = row where pos < n, else ``pad_id``; mask = f32(pos < n)."""
    rows = chunk_tokens[indices.long()]                   # (B, L)
    lens = record_lens[indices.long()][:, None]           # (B, 1)
    pos = torch.arange(chunk_tokens.shape[1], device=chunk_tokens.device)[None, :]
    valid = pos < lens
    return torch.where(valid, rows, pad_id), valid.to(torch.float32)


def chunk_gather_train_ref(chunk_tokens, record_lens, indices, *, seq_len, pad_id=0):
    """tokens = row[:S] where pos < n, targets = row[1:S+1] where pos+1 < n,
    loss_mask = f32(pos+1 < n); ``pad_id`` elsewhere."""
    rows = chunk_tokens[indices.long()]                   # (B, Lp)
    lens = record_lens[indices.long()][:, None]           # (B, 1)
    pos = torch.arange(seq_len, device=chunk_tokens.device)[None, :]
    tokens = torch.where(pos < lens, rows[:, :seq_len], pad_id)
    targets = torch.where(pos + 1 < lens, rows[:, 1 : seq_len + 1], pad_id)
    mask = (pos + 1 < lens).to(torch.float32)
    return tokens, targets, mask
