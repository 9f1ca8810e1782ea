"""Synthetic datasets for tests, benchmarks, and the end-to-end example.

Two generators:

* :func:`paper_like_sizes` — file-size distributions matching the paper's
  datasets (ImageNet-1k ≈ 110 KB mean lognormal, LibriSpeech ≈ 200 KB,
  ImageNet-21k ≈ 85 KB) so the I/O benchmarks see realistic size skew.
* :class:`SyntheticTokenDataset` — an actual materialisable token dataset
  (Zipf-distributed vocabulary, Markov-ish structure so a language model
  has something learnable) used by the convergence experiment and the
  end-to-end training example.
"""

from __future__ import annotations

import numpy as np

from ..core.chunking import ChunkingPlan
from ..core.storage import ChunkStore
from .tokens import encode_record

__all__ = ["paper_like_sizes", "SyntheticTokenDataset"]

_PROFILES = {
    # mean_bytes, sigma of lognormal (paper: "file sizes vary from a few KB
    # to several hundred KB")
    "imagenet1k": (110_000, 0.6),
    "imagenet21k": (85_000, 0.7),
    "librispeech": (200_000, 0.5),
}


def paper_like_sizes(profile: str, num_files: int, seed: int = 0) -> np.ndarray:
    """File-size array (bytes) following one of the paper's dataset profiles."""
    mean, sigma = _PROFILES[profile]
    rng = np.random.default_rng((seed, hash(profile) & 0xFFFF))
    mu = np.log(mean) - sigma**2 / 2
    sizes = rng.lognormal(mu, sigma, size=num_files)
    return np.maximum(sizes, 1024).astype(np.int64)


class SyntheticTokenDataset:
    """Learnable synthetic token corpus with variable-length documents."""

    def __init__(
        self,
        num_docs: int,
        vocab_size: int,
        mean_len: int = 256,
        min_len: int = 32,
        seed: int = 0,
    ):
        self.num_docs = num_docs
        self.vocab_size = vocab_size
        self.seed = seed
        rng = np.random.default_rng((seed, 11))
        lens = rng.geometric(1.0 / mean_len, size=num_docs) + min_len
        self.lengths = np.minimum(lens, 4 * mean_len).astype(np.int64)
        self.sizes_bytes = (self.lengths * 4).astype(np.int64)
        # A tiny order-1 Markov structure: next-token distribution depends on
        # current token's bucket -> the LM has signal to learn, so the
        # convergence benchmark (paper Fig. 15) is meaningful.
        self._buckets = 16

    def record_tokens(self, doc_id: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, 13, doc_id))
        n = int(self.lengths[doc_id])
        toks = np.empty(n, dtype=np.int32)
        toks[0] = rng.integers(self.vocab_size)
        bucket_width = max(self.vocab_size // self._buckets, 1)
        for i in range(1, n):
            b = (int(toks[i - 1]) // bucket_width) % self._buckets
            center = (b * 37 + 11) % self.vocab_size
            toks[i] = (center + rng.integers(bucket_width)) % self.vocab_size
        return toks

    def __getitem__(self, doc_id: int) -> bytes:
        return encode_record(self.record_tokens(doc_id))

    def build_store(
        self, root, chunk_size: int, *, num_slots: int | None = None,
        memory_bytes: int | None = None, seed: int = 0, backend="vfs",
        spec=None, codec=None, level=None, bands=None,
    ) -> ChunkStore:
        """Materialise the corpus as a chunk store at ``root``.

        ``spec``/``codec``/``level``/``bands`` pass straight through to
        :meth:`ChunkStore.build` (with ``spec=`` the backend belongs in
        the spec, matching the store's own contract).
        """
        plan = ChunkingPlan.create(
            self.sizes_bytes, chunk_size,
            num_slots=num_slots, memory_bytes=memory_bytes, seed=seed,
        )
        if spec is not None:
            # Forward everything so ChunkStore.build can reject the
            # spec-plus-kwargs conflict itself (our "vfs" default is not
            # an explicit backend choice, so it doesn't conflict).
            return ChunkStore.build(
                root, plan, self, spec=spec,
                backend=None if backend == "vfs" else backend,
                codec=codec, level=level, bands=bands,
            )
        return ChunkStore.build(
            root, plan, self, backend=backend,
            codec=codec, level=level, bands=bands,
        )
