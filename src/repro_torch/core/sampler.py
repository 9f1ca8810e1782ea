"""Epoch access-sequence generation and per-node partitioning (paper §2.1, §3.4).

The DL framework owns randomness: at each epoch it shuffles ``range(N)``
with a seeded RNG and walks that sequence. Redox never alters the sequence —
it redirects *what data* each index returns. In the distributed setting the
global sequence is partitioned evenly across nodes exactly like
``torch.utils.data.DistributedSampler`` (strided: node r takes positions
``r::num_nodes``), and — crucially for the prefetch protocol — the
*pre-generated* per-node sequences are replicated to every node so an owner
can look ahead into any requester's future accesses.
"""

from __future__ import annotations

import numpy as np

__all__ = ["EpochSampler"]


class EpochSampler:
    """Deterministic per-epoch global shuffles, partitioned across nodes."""

    def __init__(self, num_files: int, num_nodes: int = 1, seed: int = 1234):
        if num_nodes < 1:
            raise ValueError("num_nodes >= 1")
        self.num_files = num_files
        self.num_nodes = num_nodes
        self.seed = seed

    def global_sequence(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self.num_files).astype(np.int64)

    def node_sequences(self, epoch: int) -> list[np.ndarray]:
        """Strided even partition of the global sequence (replicated to all)."""
        seq = self.global_sequence(epoch)
        return [seq[r :: self.num_nodes] for r in range(self.num_nodes)]
