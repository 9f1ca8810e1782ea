"""The one generator of training traffic: a token dataset made from a mix's
parameters and the run's seed.

The recipe is the launcher's synthetic corpus (``SyntheticTokenDataset``
in the program): record lengths geometric with mean ``mean_len``, plus
``min_len``, capped at ``max_len``; tokens a Markov chain over 16 buckets
of the vocabulary, ``t_i = (center(bucket(t_{i-1})) + u_i) % vocab`` with
``u_i`` uniform over a bucket's width. Two departures make a run's work the
same for every seed:

- the lengths are the distribution's quantiles at ``(i + 1/2) / records``,
  the same multiset for every seed; the seed only assigns them to record
  ids, so a window of whole epochs trains the same tokens whatever the
  seed, in another order;
- the chain is drawn for all records at once, position by position, so a
  run's set-up does not pay a Python loop a token.
"""

from __future__ import annotations

import numpy as np

__all__ = ["TokenDataset", "loss_tokens", "quantile_lengths"]

BUCKETS = 16


def quantile_lengths(records: int, mean_len: int, min_len: int, max_len: int) -> np.ndarray:
    """The recipe's length distribution as ``records`` quantiles, ascending:
    ``min(G + min_len, max_len)`` with ``G`` geometric on 1, 2, ... of
    mean ``mean_len``."""
    p = 1.0 / mean_len
    q = (np.arange(records) + 0.5) / records
    g = np.maximum(np.ceil(np.log1p(-q) / np.log1p(-p)), 1).astype(np.int64)
    return np.minimum(g + min_len, max_len)


def loss_tokens(lengths: np.ndarray, seq_len: int) -> np.ndarray:
    """Loss-bearing positions of each record in a row of ``seq_len``: its
    first ``min(len, seq_len + 1)`` tokens give that many minus one
    next-token targets."""
    return np.minimum(np.asarray(lengths, dtype=np.int64), seq_len + 1) - 1


class TokenDataset:
    """``records`` token records of a mix, made from ``seed``; indexable by
    record id for the record's bytes (little-endian int32 tokens)."""

    def __init__(self, mix: dict, vocab_size: int, seed: int):
        self.vocab_size = vocab_size
        n = mix["records"]
        rng = np.random.default_rng((seed, 11))
        quant = quantile_lengths(n, mix["mean_len"], mix["min_len"], mix["max_len"])
        self.lengths = quant[rng.permutation(n)]
        self.sizes_bytes = self.lengths * 4
        self.tokens = self._chain(np.random.default_rng((seed, 13)), int(self.lengths.max()))

    def _chain(self, rng, width: int) -> np.ndarray:
        """(records, width) int32: every record's chain to ``width``; a
        record is its row's first ``length`` tokens."""
        n, v = len(self.lengths), self.vocab_size
        bucket_width = max(v // BUCKETS, 1)
        steps = rng.integers(bucket_width, size=(n, width))
        out = np.empty((n, width), dtype=np.int64)
        out[:, 0] = rng.integers(v, size=n)
        for i in range(1, width):
            center = ((out[:, i - 1] // bucket_width) % BUCKETS * 37 + 11) % v
            out[:, i] = (center + steps[:, i]) % v
        return out.astype(np.int32)

    def __len__(self) -> int:
        return len(self.lengths)

    def record(self, i: int) -> np.ndarray:
        return self.tokens[i, :self.lengths[i]]

    def __getitem__(self, i: int) -> bytes:
        return self.record(int(i)).tobytes()
