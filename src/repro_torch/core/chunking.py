"""Chunk generation and the chunk → abstract-chunk mapping (paper §3.2, Fig. 2).

Terminology (kept 1:1 with the paper):

* **file** — one training record (variable size). ``N`` files total.
* **chunk** — ``chunk_size`` (``c``) consecutive files of a one-time global
  shuffle, stored contiguously so a chunk is read from storage in one batched
  request. Chunk membership is fixed at dataset-preparation time and reused
  across epochs *and* across training jobs.
* **slot** — a file's index inside its chunk (``0 .. c-1``).
* **abstract chunk** — ``c`` abstract memory locations. There are
  ``A = M // c`` abstract chunks for ``M`` abstract memory locations
  (``M ≈ memory_bytes / mean_file_size``).
* **chunk group** — the ``n = ceil(num_chunks / A)`` chunks mapped onto one
  abstract chunk. The paper picks *consecutive* chunks per group (it argues
  interleaving buys nothing because returned data is random anyway); we do
  the same.
* **abstract location id** — ``group_id * c + slot``; globally unique.

The plan is pure metadata (numpy arrays); no file bytes are touched here.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
from pathlib import Path

import numpy as np

__all__ = ["ChunkingPlan"]


@dataclasses.dataclass(frozen=True)
class ChunkingPlan:
    """Immutable description of the file → chunk → abstract-chunk mapping."""

    num_files: int
    chunk_size: int
    num_chunks: int
    num_groups: int  # == number of abstract chunks (A)
    group_width: int  # n: max chunks per group
    seed: int

    file_sizes: np.ndarray  # int64[N] bytes
    # chunk_files[k, j] = file id at slot j of chunk k, or -1 (partial last chunk)
    chunk_files: np.ndarray  # int64[num_chunks, c]
    chunk_of: np.ndarray  # int32[N]
    slot_of: np.ndarray  # int32[N]
    group_of_chunk: np.ndarray  # int32[num_chunks]
    chunk_bytes: np.ndarray  # int64[num_chunks] total bytes incl. every member file

    # ------------------------------------------------------------------ build
    @staticmethod
    def create(
        file_sizes: np.ndarray,
        chunk_size: int,
        *,
        num_slots: int | None = None,
        memory_bytes: int | None = None,
        seed: int = 0,
    ) -> "ChunkingPlan":
        """Build the one-time plan (paper Fig. 2a/2b).

        Exactly one of ``num_slots`` (M) or ``memory_bytes`` (C) must be
        given; the paper sets ``M = C / mean_file_size``.
        """
        file_sizes = np.asarray(file_sizes, dtype=np.int64)
        n_files = int(file_sizes.shape[0])
        if n_files == 0:
            raise ValueError("empty dataset")
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if (num_slots is None) == (memory_bytes is None):
            raise ValueError("give exactly one of num_slots / memory_bytes")
        if num_slots is None:
            mean_size = float(file_sizes.mean())
            num_slots = max(int(memory_bytes / mean_size), chunk_size)
        # M must cover at least one abstract chunk.
        num_slots = max(int(num_slots), chunk_size)

        num_chunks = math.ceil(n_files / chunk_size)
        num_groups = min(max(num_slots // chunk_size, 1), num_chunks)
        group_width = math.ceil(num_chunks / num_groups)

        rng = np.random.default_rng(seed)
        perm = rng.permutation(n_files).astype(np.int64)

        chunk_files = np.full((num_chunks, chunk_size), -1, dtype=np.int64)
        flat = chunk_files.reshape(-1)
        flat[:n_files] = perm

        chunk_of = np.empty(n_files, dtype=np.int32)
        slot_of = np.empty(n_files, dtype=np.int32)
        k_idx = np.arange(num_chunks * chunk_size) // chunk_size
        s_idx = np.arange(num_chunks * chunk_size) % chunk_size
        chunk_of[perm] = k_idx[:n_files].astype(np.int32)
        slot_of[perm] = s_idx[:n_files].astype(np.int32)

        group_of_chunk = (
            np.arange(num_chunks, dtype=np.int32) // group_width
        ).astype(np.int32)

        padded_sizes = np.where(chunk_files >= 0, file_sizes[np.maximum(chunk_files, 0)], 0)
        chunk_bytes = padded_sizes.sum(axis=1).astype(np.int64)

        return ChunkingPlan(
            num_files=n_files,
            chunk_size=chunk_size,
            num_chunks=num_chunks,
            num_groups=num_groups,
            group_width=group_width,
            seed=seed,
            file_sizes=file_sizes,
            chunk_files=chunk_files,
            chunk_of=chunk_of,
            slot_of=slot_of,
            group_of_chunk=group_of_chunk,
            chunk_bytes=chunk_bytes,
        )

    # ------------------------------------------------------------- accessors
    @property
    def num_slots(self) -> int:
        """Total abstract memory locations M (= A * c)."""
        return self.num_groups * self.chunk_size

    @functools.cached_property
    def chunk_valid(self) -> np.ndarray:
        """bool[num_chunks, c]: real member at (chunk, slot) (plan is
        immutable, so the protocol hot path caches this once)."""
        return self.chunk_files >= 0

    @functools.cached_property
    def chunk_files_clipped(self) -> np.ndarray:
        """``maximum(chunk_files, 0)``: safe gather index for -1 padding."""
        return np.maximum(self.chunk_files, 0)

    def group_chunk_range(self, group: int) -> tuple[int, int]:
        """Half-open chunk-id range [start, end) of ``group``."""
        start = group * self.group_width
        end = min(start + self.group_width, self.num_chunks)
        return start, end

    def group_of_file(self, file_id: int) -> int:
        return int(self.group_of_chunk[self.chunk_of[file_id]])

    def location_of_file(self, file_id: int) -> int:
        """Abstract location id = group * chunk_size + slot (paper Fig. 2b)."""
        return self.group_of_file(file_id) * self.chunk_size + int(self.slot_of[file_id])

    def locations_of_files(self, file_ids: np.ndarray) -> np.ndarray:
        """Vectorised :meth:`location_of_file`."""
        file_ids = np.asarray(file_ids)
        groups = self.group_of_chunk[self.chunk_of[file_ids]].astype(np.int64)
        return groups * self.chunk_size + self.slot_of[file_ids]

    def files_in_chunk(self, chunk: int) -> np.ndarray:
        files = self.chunk_files[chunk]
        return files[files >= 0]

    # ------------------------------------------------------------ persistence
    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path,
            meta=json.dumps(
                dict(
                    num_files=self.num_files,
                    chunk_size=self.chunk_size,
                    num_chunks=self.num_chunks,
                    num_groups=self.num_groups,
                    group_width=self.group_width,
                    seed=self.seed,
                )
            ),
            file_sizes=self.file_sizes,
            chunk_files=self.chunk_files,
            chunk_of=self.chunk_of,
            slot_of=self.slot_of,
            group_of_chunk=self.group_of_chunk,
            chunk_bytes=self.chunk_bytes,
        )

    @staticmethod
    def load(path: str | Path) -> "ChunkingPlan":
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            return ChunkingPlan(
                **meta,
                file_sizes=z["file_sizes"],
                chunk_files=z["chunk_files"],
                chunk_of=z["chunk_of"],
                slot_of=z["slot_of"],
                group_of_chunk=z["group_of_chunk"],
                chunk_bytes=z["chunk_bytes"],
            )
