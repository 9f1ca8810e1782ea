"""mmap backend: zero-copy chunk reads through the page cache.

Each chunk file is mapped once and kept mapped; reads return
``memoryview`` slices of the map instead of copied ``bytes``. Record
payloads flow into ``np.frombuffer`` (decode) without an intermediate
copy, so a chunk's bytes cross from the page cache straight into batch
assembly — the paper's "batched read" with the kernel doing the batching.

Slicing a memoryview is O(1); the copy happens only when tokens are packed
into the fixed-shape training grid.
"""

from __future__ import annotations

import mmap
import os
import threading
import time
from pathlib import Path

from .base import StorageBackend

__all__ = ["MmapBackend"]


class MmapBackend(StorageBackend):
    """Zero-copy backend: files mapped read-only, reads are views."""

    name = "mmap"

    def __init__(self) -> None:
        super().__init__()
        self._maps: dict[Path, mmap.mmap] = {}
        self._lock = threading.Lock()

    def _map(self, path: Path) -> mmap.mmap:
        with self._lock:
            mm = self._maps.get(path)
            if mm is None:
                fd = os.open(path, os.O_RDONLY)
                try:
                    mm = mmap.mmap(fd, 0, access=mmap.ACCESS_READ)
                finally:
                    os.close(fd)
                self.stats.file_opens += 1
                self._maps[path] = mm
            return mm

    def read(self, path: Path) -> memoryview:
        t0 = time.perf_counter()
        view = memoryview(self._map(path))
        elapsed = time.perf_counter() - t0
        payload, nraw, decode_s, decoded = self._run_decoder(view)
        with self._lock:
            self.stats.wait_seconds += elapsed
            self.stats.chunk_reads += 1
            self.stats.bytes_read += nraw
            self.stats.decode_seconds += decode_s
            self.stats.decoded_bytes += decoded
        return payload

    def read_range(self, path: Path, offset: int, length: int) -> memoryview:
        t0 = time.perf_counter()
        view = memoryview(self._map(path))[offset : offset + length]
        with self._lock:
            self.stats.wait_seconds += time.perf_counter() - t0
            self.stats.ranged_reads += 1
            self.stats.bytes_read += length
        return view

    def close(self) -> None:
        with self._lock:
            for mm in self._maps.values():
                try:
                    mm.close()
                except BufferError:
                    # A consumer still holds a view into this map (e.g. an
                    # undecoded record); the map is reclaimed when they drop it.
                    pass
            self._maps.clear()
