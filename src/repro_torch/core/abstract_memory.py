"""Abstract memory: virtual slots with dynamic byte accounting (paper §3.2, Fig. 3).

An abstract memory location is *not* bound to physical memory. Bytes are
allocated when a file becomes resident in a slot and freed the moment the
file is consumed (self-invalidation) or shipped to a remote node (prefetch).
This lets variable-sized files share one location without fragmentation —
the paper's answer to variable data-access granularity.
"""

from __future__ import annotations

import numpy as np

__all__ = ["AbstractMemory"]

EMPTY = np.int64(-1)


class AbstractMemory:
    """Slot table for one node's *local* abstract memory.

    ``resident[g, s]`` holds the file id currently cached at abstract
    location ``g * c + s`` or ``-1``. Byte usage is tracked exactly so the
    benchmarks can report peak physical footprint against the node's budget.
    """

    def __init__(self, num_groups: int, chunk_size: int, file_sizes: np.ndarray):
        self.num_groups = num_groups
        self.chunk_size = chunk_size
        self._file_sizes = file_sizes
        self.resident = np.full((num_groups, chunk_size), EMPTY, dtype=np.int64)
        #: flat view sharing storage with ``resident`` — batched engines
        #: gather/scatter by abstract location id (= g * c + s) directly.
        self.resident_flat = self.resident.reshape(-1)
        self.used_bytes = 0
        self.peak_bytes = 0
        self.resident_count = 0

    # ----------------------------------------------------------- operations
    def get(self, group: int, slot: int) -> int:
        """File id at (group, slot) or -1."""
        return int(self.resident[group, slot])

    def fill(self, group: int, slot: int, file_id: int) -> None:
        """Place ``file_id`` into an *empty* slot (never-evict invariant)."""
        assert self.resident[group, slot] == EMPTY, (
            "never-evict violated: attempted to overwrite a valid slot"
        )
        self.resident[group, slot] = file_id
        size = int(self._file_sizes[file_id])
        self.used_bytes += size
        self.resident_count += 1
        if self.used_bytes > self.peak_bytes:
            self.peak_bytes = self.used_bytes

    def take(self, group: int, slot: int) -> int:
        """Remove and return the file at (group, slot).

        Used both by self-invalidation on consumption (paper Fig. 4) and by
        the prefetch path, where the sender's copy is considered consumed
        the moment it is shipped (paper §3.4).
        """
        file_id = int(self.resident[group, slot])
        assert file_id >= 0, "take() on empty slot"
        self.resident[group, slot] = EMPTY
        self.used_bytes -= int(self._file_sizes[file_id])
        self.resident_count -= 1
        return file_id

    # ------------------------------------------------------- batched variants
    def fill_many(self, group: int, slots: np.ndarray, file_ids: np.ndarray) -> None:
        """Vectorised :meth:`fill` of several slots of one group (chunk merge)."""
        assert (self.resident[group, slots] == EMPTY).all(), (
            "never-evict violated: attempted to overwrite a valid slot"
        )
        self.resident[group, slots] = file_ids
        self.used_bytes += int(self._file_sizes[file_ids].sum())
        self.resident_count += int(file_ids.size)
        if self.used_bytes > self.peak_bytes:
            self.peak_bytes = self.used_bytes

    def take_many(self, groups: np.ndarray, slots: np.ndarray) -> np.ndarray:
        """Vectorised :meth:`take` of several (group, slot) locations.

        The caller guarantees the locations are distinct and resident — the
        batched hit path only ever takes first occurrences of valid slots.
        """
        return self.take_many_flat(groups * self.chunk_size + slots)

    def take_many_flat(self, locs: np.ndarray) -> np.ndarray:
        """:meth:`take_many` addressed by abstract location id."""
        file_ids = self.resident_flat[locs]
        assert (file_ids >= 0).all(), "take_many() on an empty slot"
        self.resident_flat[locs] = EMPTY
        self.used_bytes -= int(self._file_sizes[file_ids].sum())
        self.resident_count -= int(file_ids.size)
        return file_ids

    # ------------------------------------------------------------- queries
    def group_empty_mask(self, group: int) -> np.ndarray:
        """bool[c]: which slots of ``group``'s abstract chunk are empty."""
        return self.resident[group] == EMPTY

    def is_empty(self) -> bool:
        return self.resident_count == 0
