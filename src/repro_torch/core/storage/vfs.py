"""VFS backend: plain POSIX reads, like the paper's implementation.

Synchronous ``open``/``pread`` with a bounded file-descriptor cache, so
repeated ranged reads against the same chunk file (the per-file baseline
pattern, and :meth:`ChunkStore.read_file`) do not pay an ``open()`` per
call. ``os.pread`` keeps reads positionless, so one cached descriptor is
safe under concurrent use from the parallel backend's worker threads.

``latency_s`` optionally emulates per-operation storage head time (the
NAS access overhead of ``benchmarks/calibration.py``): local benchmark
files sit in the page cache, where every read is a microsecond memcpy, so
without it no storage stall exists to overlap. The sleep blocks exactly
like a real storage op (GIL released), which is what lets the parallel
backend's readahead demonstrate its overlap honestly on a local FS.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from pathlib import Path

from .base import StorageBackend

__all__ = ["VFSBackend"]


class VFSBackend(StorageBackend):
    """Baseline backend: one syscall per read, descriptors cached (LRU)."""

    name = "vfs"

    def __init__(self, max_handles: int = 128, latency_s: float = 0.0):
        super().__init__()
        self.max_handles = int(max_handles)
        self.latency_s = float(latency_s)
        self._fds: "OrderedDict[Path, int]" = OrderedDict()
        # fd -> in-flight reads; an evicted/closed backend never closes a
        # descriptor out from under a concurrent reader (that would raise
        # EBADF — or silently read the wrong file if the fd number were
        # reused by a new open). Eviction defers the close until release.
        self._refs: dict[int, int] = {}
        self._defunct: set[int] = set()
        self._lock = threading.Lock()

    def _acquire(self, path: Path) -> int:
        with self._lock:
            fd = self._fds.get(path)
            if fd is not None:
                self._fds.move_to_end(path)
            else:
                fd = os.open(path, os.O_RDONLY)
                self.stats.file_opens += 1
                self._fds[path] = fd
                while len(self._fds) > self.max_handles:
                    _, old = self._fds.popitem(last=False)
                    if self._refs.get(old, 0) == 0:
                        os.close(old)
                    else:
                        self._defunct.add(old)
            self._refs[fd] = self._refs.get(fd, 0) + 1
            return fd

    def _release(self, fd: int) -> None:
        with self._lock:
            n = self._refs.get(fd, 0) - 1
            if n > 0:
                self._refs[fd] = n
                return
            self._refs.pop(fd, None)
            if fd in self._defunct:
                self._defunct.discard(fd)
                os.close(fd)

    def read(self, path: Path) -> bytes:
        fd = self._acquire(path)
        try:
            size = os.fstat(fd).st_size
            t0 = time.perf_counter()
            if self.latency_s:
                time.sleep(self.latency_s)
            blob = os.pread(fd, size, 0)
        finally:
            self._release(fd)
        elapsed = time.perf_counter() - t0
        payload, nraw, decode_s, decoded = self._run_decoder(blob)
        with self._lock:
            self.stats.wait_seconds += elapsed
            self.stats.chunk_reads += 1
            self.stats.bytes_read += nraw
            self.stats.decode_seconds += decode_s
            self.stats.decoded_bytes += decoded
        return payload

    def read_range(self, path: Path, offset: int, length: int) -> bytes:
        fd = self._acquire(path)
        try:
            t0 = time.perf_counter()
            if self.latency_s:
                time.sleep(self.latency_s)
            blob = os.pread(fd, length, offset)
        finally:
            self._release(fd)
        with self._lock:
            self.stats.wait_seconds += time.perf_counter() - t0
            self.stats.ranged_reads += 1
            self.stats.bytes_read += len(blob)
        return blob

    def close(self) -> None:
        with self._lock:
            for fd in self._fds.values():
                if self._refs.get(fd, 0) == 0:
                    os.close(fd)
                else:
                    self._defunct.add(fd)  # closed by the last reader
            self._fds.clear()
