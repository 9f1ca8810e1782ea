"""Bytes the training gather (``chunk_gather_train``) must move for a batch,
whatever implements it.

Each input byte the call needs is read once: the ``B`` int32 redirection
indices, the int32 length of each distinct selected slot row, and the
first ``min(len, S + 1)`` int32 tokens of each distinct selected row
(the next-token targets need the one past ``S``). The outputs are written
once: tokens and targets (int32) and the loss mask (f32), ``B x S`` each.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gather_bytes"]


def gather_bytes(row_records, lengths, seq_len: int) -> int:
    """``row_records`` the record id of each of the batch's rows,
    ``lengths`` every record's length (tokens)."""
    ids = np.asarray(row_records, dtype=np.int64)
    rows = np.unique(ids)
    row_tokens = int(np.minimum(np.asarray(lengths)[rows], seq_len + 1).sum())
    b = ids.size
    return 4 * b + 4 * rows.size + 4 * row_tokens + 3 * 4 * b * seq_len
