"""Low-overhead span tracer with Chrome-trace/Perfetto JSON export.

One process-wide :class:`Tracer` (installed with :func:`enable`, removed
with :func:`disable`) collects ``(name, cat, ts, dur, tid, args)`` events
into a bounded thread-safe ring. Instrumentation sites call the module
API::

    from repro_torch.obs import trace

    with trace.span("storage.read_chunk", "read", chunk=k):
        ...                      # timed while a tracer is installed
    trace.instant("residency.evict", "read", chunk=k)

and pay only a module-attribute load + ``None`` check when tracing is off
— the disabled path allocates nothing and takes no locks, which is what
keeps the instrumented hot loops (protocol step, ring write, staging)
inside the <5% overhead budget pinned by ``tests/test_obs.py``.

Design notes:

* the ring is a ``collections.deque(maxlen=capacity)`` — appends are
  atomic under the GIL, so producer threads never contend on a lock;
  overflow silently drops the *oldest* events (``dropped`` counts them),
  which is the right bias for "dump the trace at the end of the run".
* timestamps are ``perf_counter`` seconds relative to the tracer's epoch;
  export converts to the microseconds Chrome's ``chrome://tracing`` and
  Perfetto's trace processor expect (``ph: "X"`` complete events).
* spans nest naturally: each ``with`` records one complete event at exit,
  and the viewer reconstructs the stack per thread from containment.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from pathlib import Path

__all__ = [
    "Tracer",
    "disable",
    "enable",
    "get",
    "instant",
    "span",
    "tracing",
]


class _NullSpan:
    """Shared, reentrant no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records a complete event when the ``with`` exits."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer.complete(
            self.name, self.cat, self._t0, t1 - self._t0, self.args
        )
        return False


class Tracer:
    """Thread-safe bounded ring of trace events."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._recorded = 0
        self._epoch = time.perf_counter()
        self._tid_lock = threading.Lock()
        self._tids: "dict[int, int]" = {}
        self._tid_names: "dict[int, str]" = {}

    # ------------------------------------------------------------ recording
    def _tid(self) -> int:
        """Small stable id for the calling thread (Chrome tid field)."""
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._tid_lock:
                tid = self._tids.setdefault(ident, len(self._tids))
                self._tid_names.setdefault(
                    tid, threading.current_thread().name
                )
        return tid

    def span(self, name: str, cat: str = "", **args) -> _Span:
        return _Span(self, name, cat, args or None)

    def complete(
        self, name: str, cat: str, t0: float, dur: float, args=None
    ) -> None:
        """Record a finished span: ``t0`` is absolute ``perf_counter``."""
        self._events.append(
            (name, cat, t0 - self._epoch, dur, self._tid(), args)
        )
        self._recorded += 1

    def instant(self, name: str, cat: str = "", **args) -> None:
        """Record a zero-duration point event."""
        self.complete(name, cat, time.perf_counter(), -1.0, args or None)

    # ------------------------------------------------------------ inspection
    def __len__(self) -> int:
        return len(self._events)

    @property
    def dropped(self) -> int:
        """Events lost to ring overflow (oldest-first)."""
        return self._recorded - len(self._events)

    def events(self) -> "list[tuple]":
        """Snapshot of the ring: ``(name, cat, ts_s, dur_s, tid, args)``
        tuples (``dur_s < 0`` marks an instant event)."""
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()
        self._recorded = 0

    # -------------------------------------------------------------- export
    def to_chrome(self) -> dict:
        """The Chrome Trace Event JSON object (Perfetto-loadable)."""
        trace_events = []
        for tid, tname in sorted(self._tid_names.items()):
            trace_events.append({
                "ph": "M", "pid": 0, "tid": tid, "name": "thread_name",
                "args": {"name": tname},
            })
        for name, cat, ts, dur, tid, args in self._events:
            ev = {
                "name": name,
                "cat": cat or "default",
                "pid": 0,
                "tid": tid,
                "ts": round(ts * 1e6, 3),
            }
            if dur < 0:
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = round(dur * 1e6, 3)
            if args:
                ev["args"] = {k: _jsonable(v) for k, v in args.items()}
            trace_events.append(ev)
        return {
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def dump(self, path: "str | Path") -> Path:
        """Write the Chrome-trace JSON to ``path`` (open in Perfetto UI or
        ``chrome://tracing``)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_chrome()))
        return path


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:
        return int(v)  # numpy scalars
    except (TypeError, ValueError):
        return str(v)


# ------------------------------------------------------------- module state
_active: "Tracer | None" = None


def enable(capacity: int = 65536) -> Tracer:
    """Install (and return) the process-wide tracer. Idempotent-ish: a
    second ``enable`` replaces the tracer (the old one keeps its events)."""
    global _active
    _active = Tracer(capacity=capacity)
    return _active


def disable() -> "Tracer | None":
    """Remove the process-wide tracer; returns it (events intact)."""
    global _active
    t, _active = _active, None
    return t


def get() -> "Tracer | None":
    """The installed tracer, or None when tracing is off."""
    return _active


def span(name: str, cat: str = "", **args):
    """Module-level span: a real span when tracing is on, a shared no-op
    context manager otherwise (the hot-path fast exit)."""
    t = _active
    if t is None:
        return _NULL_SPAN
    return _Span(t, name, cat, args or None)


def instant(name: str, cat: str = "", **args) -> None:
    t = _active
    if t is not None:
        t.instant(name, cat, **args)


class tracing:
    """``with tracing() as t:`` — enable for a scope, restore on exit."""

    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self.tracer: "Tracer | None" = None

    def __enter__(self) -> Tracer:
        global _active
        self._prev = _active
        self.tracer = Tracer(capacity=self.capacity)
        _active = self.tracer
        return self.tracer

    def __exit__(self, *exc):
        global _active
        _active = self._prev
        return False
