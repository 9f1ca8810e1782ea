"""MetricsRegistry: counters, gauges, histograms + stats-dataclass absorption.

The repo's stats objects (``NodeStats``/``StepIO``/``PlannerStats``/
``ServiceStats``/``DeviceStats``/``BackendStats``) are exact protocol
counters, but each lives on its own object with its own ad-hoc reporting.
The registry gives them one export surface:

* **primitives** — ``counter()`` / ``gauge()`` / ``histogram()`` for new
  instrumentation (monotonic counts, point-in-time values, fixed-bucket
  latency distributions);
* **providers** — ``register_stats(name, fn, labels=...)`` absorbs an
  existing stats dataclass: ``fn()`` is called at :meth:`collect` time and
  every numeric field of its ``to_dict()`` becomes a ``name_field`` sample
  (so the live values are always current — nothing is copied eagerly);
* **export** — :meth:`collect` returns one flat snapshot dict (the
  transport ``metrics`` RPC payload), :meth:`exposition` renders
  Prometheus text format for scraping.

Metric identity is ``(name, frozen labels)``; labels are fixed at creation
(the common case here — per-job, per-backend) rather than per-observation.
"""

from __future__ import annotations

import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


def _label_key(labels: "dict | None") -> tuple:
    return tuple(sorted((labels or {}).items()))


def _label_str(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        self.value += amount


class Gauge:
    """Point-in-time value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class Histogram:
    """Fixed-bucket histogram (cumulative buckets, Prometheus-style)."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: "list[float]"):
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bs
        self.counts = [0] * len(bs)  # per-bucket (non-cumulative) counts
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.sum += value
        self.count += 1
        for i, b in enumerate(self.buckets):
            if value <= b:
                self.counts[i] += 1
                return
        # over the last bound: lands only in +Inf (tracked via count)

    def cumulative(self) -> "list[tuple[float, int]]":
        out, acc = [], 0
        for b, c in zip(self.buckets, self.counts):
            acc += c
            out.append((b, acc))
        return out


class MetricsRegistry:
    """One scrapeable namespace of metrics + absorbed stats dataclasses."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: "dict[tuple, Counter]" = {}
        self._gauges: "dict[tuple, Gauge]" = {}
        self._hists: "dict[tuple, Histogram]" = {}
        # name -> list of (labels, provider); providers return a stats
        # dataclass with .to_dict() (or a plain dict of numbers).
        self._providers: "dict[str, list]" = {}

    # ----------------------------------------------------------- primitives
    def counter(self, name: str, labels: "dict | None" = None) -> Counter:
        key = (name, _label_key(labels))
        with self._lock:
            return self._counters.setdefault(key, Counter())

    def gauge(self, name: str, labels: "dict | None" = None) -> Gauge:
        key = (name, _label_key(labels))
        with self._lock:
            return self._gauges.setdefault(key, Gauge())

    def histogram(
        self, name: str, buckets: "list[float]", labels: "dict | None" = None
    ) -> Histogram:
        key = (name, _label_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram(buckets)
            return h

    # ------------------------------------------------------------ providers
    def register_stats(
        self, name: str, provider, labels: "dict | None" = None
    ) -> None:
        """Absorb a stats object: ``provider()`` is called at collect time;
        every numeric field of its ``to_dict()`` (or of the dict itself)
        becomes a ``{name}_{field}`` sample under ``labels``. Re-registering
        the same ``(name, labels)`` replaces the provider (idempotent), so
        dynamic populations — transport sessions opening per job — can
        re-register on every scrape."""
        key = _label_key(labels)
        with self._lock:
            entries = self._providers.setdefault(name, [])
            entries[:] = [e for e in entries if e[0] != key]
            entries.append((key, provider))

    def unregister(self, name: str, labels: "dict | None" = None) -> None:
        key = _label_key(labels)
        with self._lock:
            entries = self._providers.get(name, [])
            entries[:] = [e for e in entries if e[0] != key]
            if not entries:
                self._providers.pop(name, None)

    def _provider_samples(self):
        with self._lock:
            providers = [
                (name, labels, fn)
                for name, entries in self._providers.items()
                for labels, fn in entries
            ]
        for name, labels, fn in providers:
            obj = fn()
            if obj is None:
                continue
            d = obj if isinstance(obj, dict) else obj.to_dict()
            for field, v in d.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                yield f"{name}_{field}", labels, v

    # --------------------------------------------------------------- export
    def collect(self) -> "dict[str, float]":
        """One flat snapshot: ``name{labels}`` -> value. This is the
        transport ``metrics`` RPC payload and the benchmark-record shape."""
        out: "dict[str, float]" = {}
        with self._lock:
            prims = (
                [(n, ls, c.value) for (n, ls), c in self._counters.items()]
                + [(n, ls, g.value) for (n, ls), g in self._gauges.items()]
            )
            hists = list(self._hists.items())
        for name, labels, value in prims:
            out[name + _label_str(labels)] = value
        for (name, labels), h in hists:
            ls = _label_str(labels)
            out[f"{name}_count{ls}"] = h.count
            out[f"{name}_sum{ls}"] = h.sum
        for name, labels, value in self._provider_samples():
            out[name + _label_str(labels)] = value
        return out

    def exposition(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        lines: "list[str]" = []
        seen_type: "set[str]" = set()

        def typed(name: str, kind: str) -> None:
            if name not in seen_type:
                seen_type.add(name)
                lines.append(f"# TYPE {name} {kind}")

        with self._lock:
            counters = sorted(
                (n, ls, c.value) for (n, ls), c in self._counters.items()
            )
            gauges = sorted(
                (n, ls, g.value) for (n, ls), g in self._gauges.items()
            )
            hists = sorted(self._hists.items())
        for name, labels, value in counters:
            typed(name, "counter")
            lines.append(f"{name}{_label_str(labels)} {_fmt(value)}")
        for name, labels, value in gauges:
            typed(name, "gauge")
            lines.append(f"{name}{_label_str(labels)} {_fmt(value)}")
        for (name, labels), h in hists:
            typed(name, "histogram")
            base = dict(labels)
            for bound, acc in h.cumulative():
                ls = _label_key({**base, "le": _fmt(bound)})
                lines.append(f"{name}_bucket{_label_str(ls)} {acc}")
            ls = _label_key({**base, "le": "+Inf"})
            lines.append(f"{name}_bucket{_label_str(ls)} {h.count}")
            lines.append(f"{name}_sum{_label_str(labels)} {_fmt(h.sum)}")
            lines.append(f"{name}_count{_label_str(labels)} {h.count}")
        for name, labels, value in sorted(self._provider_samples()):
            typed(name, "gauge")  # absorbed stats: point-in-time snapshots
            lines.append(f"{name}{_label_str(labels)} {_fmt(value)}")
        return "\n".join(lines) + "\n"


def _fmt(v) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)
