"""Fault-tolerance harness: heartbeats, failure injection, elastic restart.

Two layers of resilience (DESIGN.md §5):

1. **Training state** — periodic async checkpoints; on a detected failure
   the coordinator restarts survivors from the last step and (optionally)
   reshapes the mesh (``checkpoint.restore_checkpoint`` re-places leaves
   under any target sharding).
2. **Data plane** — the Redox cluster remaps ownership of the dead node's
   abstract chunks (``core.distributed.Cluster.fail_node``), preserving the
   exactly-once epoch guarantee (test-verified).

On real fleets the heartbeat/agreement layer is the cluster manager's job;
here a thread-based monitor demonstrates the control flow and lets tests
inject deterministic failures.
"""

from __future__ import annotations

import dataclasses
import threading
import time

__all__ = ["Heartbeat", "FailureInjector", "StragglerMonitor"]


class Heartbeat:
    """Liveness registry: workers ping; the coordinator polls for the dead."""

    def __init__(self, num_workers: int, timeout_s: float = 5.0):
        self.timeout_s = timeout_s
        self._last = {w: time.monotonic() for w in range(num_workers)}
        self._lock = threading.Lock()

    def ping(self, worker: int) -> None:
        with self._lock:
            self._last[worker] = time.monotonic()

    def dead_workers(self) -> list[int]:
        now = time.monotonic()
        with self._lock:
            return [w for w, t in self._last.items() if now - t > self.timeout_s]

    def mark_dead(self, worker: int) -> None:
        with self._lock:
            self._last[worker] = -1e18


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule for tests/benchmarks: {step: worker}."""

    schedule: dict[int, int]

    def maybe_fail(self, step: int) -> int | None:
        return self.schedule.get(step)


def _median(values: "list[float]") -> float:
    """True median: mean of the two middles for even-length input."""
    values = sorted(values)
    mid = len(values) // 2
    if len(values) % 2:
        return values[mid]
    return 0.5 * (values[mid - 1] + values[mid])


class StragglerMonitor:
    """Tracks per-worker step durations; flags workers slower than
    ``threshold`` x the median as stragglers (DESIGN.md §5: the Redox
    loader responds by deepening its prefetch queue for that worker and
    re-routing remote reads away from it).

    The reference for each worker is the *leave-one-out* true median of the
    other workers' window means, so a straggler's own slowness never
    inflates its threshold. (The old upper-middle ``med[len(med)//2]``
    median made a slow worker unflaggable in 2-worker fleets: the reference
    WAS its own mean.) A worker with an **empty window** while peers have
    data is flagged explicitly — no step reports is the strongest straggler
    signal there is.
    """

    def __init__(self, num_workers: int, window: int = 16, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self._times: list[list[float]] = [[] for _ in range(num_workers)]

    def record(self, worker: int, seconds: float) -> None:
        t = self._times[worker]
        t.append(seconds)
        if len(t) > self.window:
            t.pop(0)

    def stragglers(self) -> list[int]:
        means = {
            w: sum(t) / len(t) for w, t in enumerate(self._times) if t
        }
        if not means:
            return []  # no worker has reported yet: no baseline, no flags
        out = []
        for w, t in enumerate(self._times):
            if not t:
                out.append(w)  # peers report, this one is silent
                continue
            others = [m for w2, m in means.items() if w2 != w]
            if others and means[w] > self.threshold * _median(others):
                out.append(w)
        return out
