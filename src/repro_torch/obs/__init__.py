"""Observability plane: span tracing, metrics, epoch-time attribution.

Three pieces (see DESIGN.md §13):

* :mod:`repro.obs.tracer` — process-wide span tracer with Chrome-trace/
  Perfetto export; instrumentation sites use ``trace.span(...)`` /
  ``trace.instant(...)`` and cost a ``None`` check when tracing is off.
* :mod:`repro.obs.metrics` — :class:`MetricsRegistry` of counters /
  gauges / histograms that also absorbs the repo's stats dataclasses via
  ``register_stats``; one ``collect()`` snapshot, Prometheus text
  ``exposition()``, served live over the transport ``metrics`` RPC.
* :mod:`repro.obs.report` — fold a trace into an overlap-aware per-stage
  wall-time breakdown, device spans counted by their device intervals.
"""

from repro_torch.obs import tracer as trace
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.report import STAGES, attribution, format_report
from repro_torch.obs.tracer import Tracer, tracing

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "STAGES",
    "Tracer",
    "attribution",
    "format_report",
    "trace",
    "tracing",
]
