"""Storage backend interface: how chunk bytes reach the protocol.

The paper's claim is storage-agnostic ("it does not depend on any specific
storage"); this ABC makes that concrete. A backend maps *paths* to buffers —
it knows nothing about chunks, plans, or the protocol. :class:`ChunkStore`
owns the chunk-id -> path translation and the offset index.

Three access patterns, mirroring how training actually touches storage:

* :meth:`StorageBackend.read` — one whole-file batched read (the Redox
  chunk-load path);
* :meth:`StorageBackend.read_range` — a ranged read of one record (the
  per-file baseline path);
* :meth:`StorageBackend.prefetch` — a non-binding hint that the given paths
  will likely be read soon. Synchronous backends ignore it; the parallel
  backend turns it into bounded readahead so chunk loads overlap with
  protocol work and batch assembly.

Every backend keeps a :class:`BackendStats` so benchmarks can report
observed chunk-read throughput (bytes delivered per second the *caller*
spent blocked) per backend.
"""

from __future__ import annotations

import abc
import dataclasses
import time
from pathlib import Path

from repro_torch.core.stats import StatsDict

__all__ = ["BackendStats", "StorageBackend"]


@dataclasses.dataclass
class BackendStats(StatsDict):
    """Counters shared by all backends (times in seconds)."""

    chunk_reads: int = 0       # whole-file read() calls served
    ranged_reads: int = 0      # read_range() calls served
    bytes_read: int = 0        # payload bytes handed to callers
    file_opens: int = 0        # OS-level open()/mmap() operations
    # Caller-blocked time inside read(), split by cause. For synchronous
    # backends every read is inline, so all of it lands in wait_seconds;
    # async backends put future waits (readahead that wasn't finished in
    # time) in wait_seconds and cold-miss inline reads (nothing was ever
    # submitted for the path) in miss_read_seconds — the §6 model treats
    # them differently: misses cost full storage latency, waits shrink
    # toward zero as readahead depth grows.
    wait_seconds: float = 0.0       # blocked on a submitted read finishing
    miss_read_seconds: float = 0.0  # blocked on an inline cold-miss read
    cold_misses: int = 0       # read() calls served by neither readahead source
    prefetch_issued: int = 0   # heuristic readahead reads actually submitted
    prefetch_hits: int = 0     # read() calls served by a heuristic prefetch
    scheduled_issued: int = 0  # readahead reads submitted from an exact schedule
    scheduled_hits: int = 0    # read() calls served by the exact schedule
    peak_inflight: int = 0     # max concurrent background reads observed
    # Codec layer (DESIGN.md §15): when a decoder is installed, bytes_read
    # keeps counting *physical* (on-disk, possibly compressed) bytes, and
    # the decode cost lands here — on a worker thread for the parallel
    # backend (overlapped with disk I/O), inline for synchronous backends.
    decode_seconds: float = 0.0  # time spent inside the installed decoder
    decoded_bytes: int = 0       # logical bytes produced by eager decodes

    @property
    def blocked_seconds(self) -> float:
        """Total caller time blocked inside read(), whatever the cause."""
        return self.wait_seconds + self.miss_read_seconds

    def throughput(self) -> float:
        """Observed blocking-read throughput (bytes/s of caller wait time)."""
        blocked = self.blocked_seconds
        return self.bytes_read / blocked if blocked > 0 else 0.0


class StorageBackend(abc.ABC):
    """One way of turning a path into bytes. Stateless w.r.t. the protocol."""

    name: str = "abstract"
    #: True when prefetch() actually consumes hints — lets callers skip
    #: computing hint lists for synchronous backends entirely.
    wants_prefetch: bool = False

    def __init__(self) -> None:
        self.stats = BackendStats()
        self._decoder = None

    # --------------------------------------------------------------- decode
    def set_decoder(self, fn) -> None:
        """Install a post-read transform applied to every whole-file read.

        ``fn(raw) -> payload`` runs wherever the physical read ran — on a
        worker thread for async backends, so decompression overlaps disk
        I/O; inline for synchronous ones. :meth:`read_range` is never
        decoded (a ranged slice of a compressed frame is meaningless —
        ``ChunkStore.read_file`` routes framed stores through a cached
        whole-chunk decode instead).
        """
        self._decoder = fn

    def _run_decoder(self, raw):
        """``(payload, physical_nbytes, decode_s, decoded_nbytes)``.

        Stats are returned, not applied — the caller folds them in under
        its own stats lock.
        """
        nraw = memoryview(raw).nbytes
        if self._decoder is None:
            return raw, nraw, 0.0, 0
        t0 = time.perf_counter()
        payload = self._decoder(raw)
        elapsed = time.perf_counter() - t0
        measure = getattr(payload, "decoded_nbytes", None)
        return payload, nraw, elapsed, measure() if measure else 0

    # ------------------------------------------------------------- required
    @abc.abstractmethod
    def read(self, path: Path) -> "bytes | memoryview":
        """Read the whole file at ``path`` (one batched request)."""

    @abc.abstractmethod
    def read_range(self, path: Path, offset: int, length: int) -> "bytes | memoryview":
        """Read ``length`` bytes at ``offset`` of ``path``."""

    # ------------------------------------------------------------- optional
    def prefetch(self, paths: "list[Path]") -> None:
        """Hint that ``paths`` will be read soon. Default: no-op."""

    def schedule_reads(self, paths: "list[Path]") -> None:
        """Install the *exact* upcoming read order (clairvoyant planner).

        Unlike :meth:`prefetch` hints — which are non-binding guesses that
        may be dropped — a schedule is the ground-truth sequence of future
        :meth:`read` calls, duplicates included. Async backends keep their
        readahead window filled from its head; synchronous backends ignore
        it (the default no-op), and the hint heuristic stays as the
        fallback when no schedule is active.
        """

    @property
    def scheduled_active(self) -> bool:
        """True while an exact read schedule is installed and unexhausted."""
        return False

    def close(self) -> None:
        """Release cached handles/maps/threads. Safe to call twice."""

    def __enter__(self) -> "StorageBackend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
