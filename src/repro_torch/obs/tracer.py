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
— the disabled path allocates nothing, takes no locks and imports no
torch, which is what keeps the instrumented hot loops (protocol step, ring
write, staging) cheap (``tests/test_torch_obs.py`` pins it).

A span around work queued on the card also carries that work's *device
interval*::

    tracer = trace.get()
    if tracer is None:
        graph.replay()
    else:
        with tracer.device_span("train.step", "compute", device, step=n):
            graph.replay()       # queued on the current stream

records a timing ``torch.cuda.Event`` on the current stream at entry and
another at exit, and never synchronises. The events are resolved when the
tracer is read (:meth:`Tracer.events`, :meth:`Tracer.to_chrome`,
:meth:`Tracer.dump`), after the caller has synchronised, into the span's
args ``dev_ts`` / ``dev_dur``: seconds on the tracer's own clock, through
a linear map from two anchor events on a private stream with no queued
work (one at the first device span, one at read-out). Off the card a
device span is a host span; while the current stream captures a CUDA
graph it records nothing.

A device span may also read *device counters*, tensors that the work
accumulates on the card (``counters={name: tensor}``, e.g. a model's
``device_counters()``): each is copied on the span's stream at entry and
at exit, never read on the host inside the span, and resolved at read-out
into ``args["counters"][name]``, the exit copy less the entry copy as
nested lists, the span's own counts.

*Host tallies* are process-wide dicts of counts that code adds to as it
queues device work (:func:`host_tally`, e.g. ``attn.flash_calls``, the
flash-attention training launches and their FLOPs that
``kernels/flash_attention/ops.py`` counts, and ``attn.mla_calls``, the
same for multi-head latent attention's (192, 128) kernels). A ``train.step`` span
(``train/train_step.py``) carries every tally's change over its step in
its args under the tally's name (:func:`tallies`, :func:`tallies_since`);
a graph replay carries what its capture queued, as it runs the same nodes.

Design notes:

* the ring is a ``collections.deque(maxlen=capacity)`` — appends are
  atomic under the GIL, so producer threads never contend on a lock;
  overflow silently drops the *oldest* events (``dropped`` counts them),
  which is the right bias for "dump the trace at the end of the run".
* timestamps are ``perf_counter`` seconds relative to the tracer's epoch;
  export converts to the microseconds Chrome's ``chrome://tracing`` and
  Perfetto's trace processor expect (``ph: "X"`` complete events).
* ``torch.profiler`` stamps its events in CLOCK_REALTIME nanoseconds
  (``time.time_ns``); ``perf_counter`` is CLOCK_MONOTONIC. The tracer
  takes the offset between the two at creation (the tightest of several
  paired reads), so :meth:`Tracer.realtime_ns` puts any of its times on
  the profiler's clock, and the Chrome export carries it in ``otherData``.
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
    "host_tally",
    "instant",
    "span",
    "tallies",
    "tallies_since",
    "tracing",
]

#: Args key of a device span's unresolved ``(start, end)`` events.
_DEV = "_dev"
#: Args key of a device span's unresolved counter copies, ``{name: (at
#: entry, at exit)}``.
_CNT = "_cnt"
#: ``Tracer.device_mark``'s answer while the current stream captures.
_CAPTURING = object()
#: The host tallies by name (:func:`host_tally`).
_TALLIES: dict[str, dict] = {}


class _NullSpan:
    """Shared, reentrant no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **args) -> None:
        pass


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

    def note(self, **args) -> None:
        """Add args known only inside the span (a count of its work)."""
        self.args = {**(self.args or {}), **args}


class _DeviceSpan(_Span):
    """A span that also brackets the work it queues on ``device``'s
    current stream with two timing events."""

    __slots__ = ("_device", "_mark", "_counters", "_before")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args, device,
                 counters=None):
        super().__init__(tracer, name, cat, args)
        self._device = device
        self._counters = counters or {}

    def __enter__(self):
        self._mark = self._tracer.device_mark(self._device)
        if self._mark is not _CAPTURING:
            self._before = {k: t.clone() for k, t in self._counters.items()}
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._mark is not _CAPTURING:
            if self._counters:
                self.args = {**(self.args or {}), _CNT: {
                    k: (self._before[k], t.clone()) for k, t in self._counters.items()}}
            self._tracer.complete(
                self.name, self.cat, self._t0, t1 - self._t0, self.args,
                mark=self._mark,
            )
        return False


def _realtime_offset_ns(pairs: int = 16) -> int:
    """CLOCK_REALTIME minus ``perf_counter`` in ns, from the tightest of
    ``pairs`` reads of the one between two reads of the other."""
    best_width, offset = None, 0
    for _ in range(pairs):
        a = time.perf_counter_ns()
        r = time.time_ns()
        b = time.perf_counter_ns()
        if best_width is None or b - a < best_width:
            best_width, offset = b - a, r - (a + b) // 2
    return offset


class _DeviceClock:
    """The device-to-host map of one tracer: an anchor event recorded on a
    private, otherwise idle stream at the first device span, and one at
    read-out; an event's host time is the first anchor's plus its elapsed
    device time scaled by the two anchors' host over device seconds.
    ``elapsed_time`` is float32 milliseconds: a few microseconds a minute
    after the first anchor."""

    def __init__(self, device):
        import torch

        # A high-priority pool stream: the program's own streams come from
        # the default-priority pool, so no work is ever queued on this one.
        self.stream = torch.cuda.Stream(device, priority=-1)
        self.first, self.first_s = self._anchor()
        self.scale, self.drift_s = 1.0, 0.0

    def _anchor(self):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        a = time.perf_counter()
        ev.record(self.stream)
        return ev, (a + time.perf_counter()) / 2

    def read_out(self) -> None:
        """Record the second anchor, wait for it, and refit the map."""
        last, last_s = self._anchor()
        last.synchronize()
        dev_s = self.first.elapsed_time(last) / 1e3
        if dev_s > 0:
            self.scale = (last_s - self.first_s) / dev_s
            self.drift_s = (last_s - self.first_s) - dev_s

    def resolve(self, start, end) -> tuple:
        """(host ``perf_counter`` start, seconds) of a device interval."""
        end.synchronize()
        t0 = self.first_s + self.first.elapsed_time(start) / 1e3 * self.scale
        return t0, start.elapsed_time(end) / 1e3 * self.scale


class Tracer:
    """Thread-safe bounded ring of trace events."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._recorded = 0
        epoch_ns = time.perf_counter_ns()
        self._epoch = epoch_ns / 1e9
        #: ``time.time_ns()`` at this tracer's time 0: the profiler's clock.
        self.realtime_origin_ns = epoch_ns + _realtime_offset_ns()
        self._clock: "_DeviceClock | None" = None
        self._clock_lock = threading.Lock()
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

    def device_span(self, name: str, cat: str, device, *, counters=None, **args) -> _Span:
        return _DeviceSpan(self, name, cat, args or None, device, counters)

    def device_mark(self, device):
        """Start a device interval on ``device``'s current stream: a
        ``(stream, event)`` mark for :meth:`complete`, None off the card,
        and ``_CAPTURING`` while the current stream captures a graph (an
        event recorded there would join the graph)."""
        if getattr(device, "type", device) != "cuda":
            return None
        import torch

        if torch.cuda.is_current_stream_capturing():
            return _CAPTURING
        if self._clock is None:
            with self._clock_lock:
                if self._clock is None:
                    self._clock = _DeviceClock(device)
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        return stream, start

    def complete(
        self, name: str, cat: str, t0: float, dur: float, args=None, *,
        mark=None,
    ) -> None:
        """Record a finished span: ``t0`` is absolute ``perf_counter``.
        ``mark`` (from :meth:`device_mark`) closes a device interval with
        an event on the mark's stream, resolved at read-out."""
        if mark is not None:
            import torch

            stream, start = mark
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            args = {**(args or {}), _DEV: (start, end)}
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
        tuples (``dur_s < 0`` marks an instant event). Device spans have
        their intervals resolved into ``args["dev_ts"]`` / ``["dev_dur"]``
        (seconds, this tracer's clock), waiting for their events: read
        after the device work is done."""
        snapshot = list(self._events)
        pending = [ev[5] for ev in snapshot if ev[5] and _DEV in ev[5]]
        if pending:
            self._clock.read_out()
            for args in pending:
                t0, dur = self._clock.resolve(*args.pop(_DEV))
                args["dev_ts"], args["dev_dur"] = t0 - self._epoch, dur
        for ev in snapshot:
            if ev[5] and _CNT in ev[5]:
                ev[5]["counters"] = {k: (after - before).tolist()
                                     for k, (before, after) in ev[5].pop(_CNT).items()}
        return snapshot

    def realtime_ns(self, ts: float) -> int:
        """A time of this tracer (seconds from its epoch) on the profiler's
        clock, CLOCK_REALTIME ns."""
        return self.realtime_origin_ns + round(ts * 1e9)

    @property
    def device_clock(self) -> "dict | None":
        """The device-to-host map as last fitted (None before a device
        span): host over device seconds between the anchors, and their
        difference (the device clock's drift over the traced span)."""
        if self._clock is None:
            return None
        return {"scale": self._clock.scale, "drift_s": self._clock.drift_s}

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
        for name, cat, ts, dur, tid, args in self.events():
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
            "otherData": {
                "dropped_events": self.dropped,
                # ts 0 in CLOCK_REALTIME ns, torch.profiler's clock
                "realtime_origin_ns": self.realtime_origin_ns,
                "device_clock": self.device_clock,
            },
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


def host_tally(name: str, *keys: str) -> dict:
    """The host tally ``name``, made on first use with ``keys`` at 0: a
    dict of counts that code queuing device work adds to."""
    return _TALLIES.setdefault(name, dict.fromkeys(keys, 0))


def tallies() -> dict:
    """A copy of every host tally, ``{name: {key: count}}``."""
    return {name: dict(t) for name, t in _TALLIES.items()}


def tallies_since(before: dict) -> dict:
    """Every host tally's change since ``before``, a :func:`tallies` copy."""
    return {name: {k: v - before.get(name, {}).get(k, 0) for k, v in t.items()}
            for name, t in _TALLIES.items()}


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
