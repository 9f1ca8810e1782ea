"""Parallel backend: threadpool chunk reads with bounded readahead.

This is the FanStore/Clairvoyant-prefetch move applied to Redox's chunk
loads, with two sources of readahead:

* **Exact schedule** (:meth:`schedule_reads`) — the clairvoyant planner's
  global chunk-read order. The readahead window is kept filled from the
  schedule head, so every blocking :meth:`read` claims a finished (or
  in-flight) future: prefetching is exact, not speculative.
* **Heuristic hints** (:meth:`prefetch`) — the protocol's ``_refill_hints``
  guesses, used as the fallback whenever no schedule is installed.

Readahead is bounded either way: at most ``readahead`` unclaimed reads
exist at any time (in-flight + completed-but-unclaimed), so neither source
can blow up memory — excess hints are dropped, and the schedule is drained
lazily. Delegated byte access goes through an inner synchronous backend
(VFS by default), which is what makes this backend composable with any
storage medium.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

from .base import StorageBackend
from .vfs import VFSBackend

__all__ = ["ParallelBackend"]


class ParallelBackend(StorageBackend):
    """Concurrent reads over an inner backend: exact schedule or hints."""

    name = "parallel"
    wants_prefetch = True

    def __init__(
        self,
        inner: StorageBackend | None = None,
        *,
        workers: int = 4,
        readahead: int = 8,
    ):
        super().__init__()
        self.inner = inner if inner is not None else VFSBackend()
        self.readahead = int(readahead)
        self._pool = ThreadPoolExecutor(
            max_workers=int(workers), thread_name_prefix="chunk-read"
        )
        self._futures: "dict[Path, Future]" = {}
        self._origin: "dict[Path, str]" = {}  # path -> 'sched' | 'hint'
        # Hints that arrived while readahead capacity was full; promoted to
        # real background reads as claims free slots. Bounded, insertion-
        # ordered (hints arrive best-first from the protocol).
        self._backlog: "OrderedDict[Path, None]" = OrderedDict()
        # The exact future read order (duplicates included), drained head-
        # first into the readahead window while capacity allows.
        self._schedule: "deque[Path]" = deque()
        self._lock = threading.Lock()
        self._closed = False

    def _read_job(self, path: Path):
        """Worker-side read + decode: decompression overlaps disk I/O.

        Returns the ``_run_decoder`` tuple so the claiming thread can fold
        physical-byte and decode-time stats in under the backend lock.
        """
        return self._run_decoder(self.inner.read(path))

    def _submit_locked(self, path: Path, origin: str = "hint") -> None:
        self._futures[path] = self._pool.submit(self._read_job, path)
        self._origin[path] = origin
        if origin == "sched":
            self.stats.scheduled_issued += 1
        else:
            self.stats.prefetch_issued += 1
        self.stats.peak_inflight = max(self.stats.peak_inflight, len(self._futures))

    def _top_up_schedule_locked(self) -> None:
        while self._schedule and len(self._futures) < self.readahead:
            if self._schedule[0] in self._futures:
                # A duplicate of an in-flight read: later occurrences are
                # resubmitted after the first is claimed, keeping order.
                break
            self._submit_locked(self._schedule.popleft(), origin="sched")

    # ------------------------------------------------------------- readahead
    def schedule_reads(self, paths: "list[Path]") -> None:
        """Install the planner's exact read order and start filling it.

        *Replaces* any previous schedule: an epoch abandoned mid-replay
        (consumer broke out of the loader) must not leave stale entries or
        stale in-flight submissions pinning the readahead window. All
        unclaimed scheduled reads are discarded with the old schedule —
        after a *completed* epoch there are none, so this only costs
        anything on the abandonment path.
        """
        with self._lock:
            if self._closed:
                return
            stale = [p for p, origin in self._origin.items() if origin == "sched"]
            for p in stale:
                fut = self._futures.pop(p, None)
                if fut is not None:
                    fut.cancel()
                del self._origin[p]
            self._schedule = deque(paths)
            self._backlog.clear()  # exact knowledge supersedes guesses
            self._top_up_schedule_locked()

    @property
    def scheduled_active(self) -> bool:
        return bool(self._schedule)

    def prefetch(self, paths: "list[Path]") -> None:
        """Submit background reads for ``paths``, up to the readahead bound.

        Overflow hints are remembered (bounded backlog) and promoted when a
        claim frees capacity, so readahead stays saturated across misses.
        Ignored while an exact schedule is active — the planner already
        knows the true read order.
        """
        with self._lock:
            if self._closed or self._schedule:
                return
            for path in paths:
                if path in self._futures:
                    continue
                if len(self._futures) < self.readahead:
                    self._backlog.pop(path, None)
                    self._submit_locked(path)
                else:
                    self._backlog[path] = None
                    while len(self._backlog) > 4 * self.readahead:
                        self._backlog.popitem(last=False)

    # ----------------------------------------------------------------- reads
    def read(self, path: Path) -> "bytes | memoryview":
        with self._lock:
            fut = self._futures.pop(path, None)
            if fut is not None:
                if self._origin.pop(path, "hint") == "sched":
                    self.stats.scheduled_hits += 1
                else:
                    self.stats.prefetch_hits += 1
            elif self._schedule and self._schedule[0] == path:
                # Cold read raced ahead of its scheduled submission (window
                # momentarily full): consume the head so order stays exact.
                self._schedule.popleft()
            self._backlog.pop(path, None)  # being read now: hint is stale
            if not self._closed:
                self._top_up_schedule_locked()
            while (
                not self._closed
                and not self._schedule
                and self._backlog
                and len(self._futures) < self.readahead
            ):
                nxt, _ = self._backlog.popitem(last=False)
                if nxt not in self._futures:
                    self._submit_locked(nxt)
        t0 = time.perf_counter()
        if fut is None:
            # Cold miss: read inline — bouncing through the pool would only
            # add a thread round trip to an already-blocking read.
            blob, nraw, decode_s, decoded = self._read_job(path)
        else:
            blob, nraw, decode_s, decoded = fut.result()
        elapsed = time.perf_counter() - t0
        with self._lock:
            # Miss latency and prefetch-wait are different failure modes
            # (no readahead issued vs readahead not finished in time), so
            # they are accounted separately — see BackendStats.
            if fut is None:
                self.stats.miss_read_seconds += elapsed
                self.stats.cold_misses += 1
            else:
                self.stats.wait_seconds += elapsed
            self.stats.chunk_reads += 1
            self.stats.bytes_read += nraw
            self.stats.decode_seconds += decode_s
            self.stats.decoded_bytes += decoded
        return blob

    def read_range(self, path: Path, offset: int, length: int) -> "bytes | memoryview":
        # Ranged record reads are the baseline path; no speculation to win.
        blob = self.inner.read_range(path, offset, length)
        with self._lock:
            self.stats.ranged_reads += 1
            self.stats.bytes_read += length
        return blob

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pending = list(self._futures.values())
            self._futures.clear()
            self._origin.clear()
            self._schedule.clear()
        for fut in pending:
            fut.cancel()
        self._pool.shutdown(wait=True)
        self.inner.close()
