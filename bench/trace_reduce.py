"""Reduce a ``torch.profiler`` trace of the window to what the readers need.

Device operations (kernels, copies, sets) are the profiler's CUDA events.
Their union is the time the device was busy; the gaps between the union's
intervals are idle time, each named by the harness's host range
(``bench.*``) that held its middle, or by the host operation that did when
no range did.
"""

from __future__ import annotations

import collections

__all__ = ["reduce"]

_TOP = 10


def _device_events(prof) -> tuple:
    """([(start_ns, end_ns, name)] on the device, [(start_ns, end_ns, name)]
    on the host), from the profiler's own events."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if dur <= 0:
            continue
        item = (start, start + dur, e.name())
        if e.name().startswith("bench."):
            continue  # the harness's own ranges, which the trace also shows on the device
        if e.device_type() == DeviceType.CUDA:
            dev.append(item)
        else:
            host.append(item)
    dev.sort()
    return dev, host


def _union(dev: list) -> list:
    merged = []
    for s, e, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label(mid: int, host: list) -> str:
    """The innermost harness range holding ``mid``, else the shortest host
    operation holding it."""
    best, best_len = None, None
    for pref in ("bench.", ""):
        for s, e, name in host:
            if s <= mid <= e and name.startswith(pref):
                if best_len is None or e - s < best_len:
                    best, best_len = name, e - s
        if best is not None:
            return best
    return "host idle"


def reduce(prof) -> dict:
    dev, host = _device_events(prof)
    if not dev:
        return {"busy_s": 0.0, "device_ops": [], "idle_gaps": [], "kernels": {}}
    merged = _union(dev)
    busy_ns = sum(e - s for s, e in merged)
    by_name: dict = collections.defaultdict(int)
    kernels: dict = collections.defaultdict(list)
    for s, e, name in dev:
        by_name[name] += e - s
        kernels[name].append(e - s)
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:_TOP]
    return {
        "busy_s": busy_ns / 1e9,
        "device_ops": [[n, t / 1e9] for n, t in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:_TOP]],
        "idle_gaps": [[_label((a + b) // 2, host), g / 1e9] for g, a, b in gaps],
        "kernels": {n: [d / 1e9 for d in ds] for n, ds in kernels.items()},
    }
