"""Epoch-time attribution: fold a trace into a per-stage wall-time budget.

A trace answers "what happened when"; training work overlaps across
threads (protocol walk ∥ chunk reads ∥ decode ∥ staging ∥ compute), so
naive per-category sums double-count and exceed wall time. This module
produces two views:

* ``busy_s[stage]`` — the *union* of that stage's span intervals (how much
  wall time the stage was active somewhere, overlap within the stage
  collapsed);
* ``exclusive_s[stage]`` — a sweep-line decomposition of the timeline:
  every instant is attributed to exactly ONE stage (the highest-priority
  stage active at that instant), so ``sum(exclusive_s) + idle_s == wall_s``
  *by construction* — the overlap-aware identity the acceptance test pins.

The priority order encodes the pipeline: ``compute`` wins (overlapped I/O
is hidden — it costs nothing, exactly the §6 ``max(compute, io)`` model),
then the consumer-visible waits (``stage``, ``ring``), then host work
(``decode``), then producer-side I/O (``read``), then bookkeeping
(``plan``, ``proto``, ``service``). ``plan`` outranks ``proto`` because a
planner span *encloses* its shadow protocol walk — planning time should
read as planning, while a live walk (no plan span active) still lands on
``proto``; ``service`` ranks last for the same reason (the pump span
encloses everything a pump round drives). Residual uncovered time is
``idle_s`` (scheduler gaps, uninstrumented work).

A span that carries a device interval (``args["dev_ts"]`` /
``["dev_dur"]``, :func:`repro_torch.obs.tracer.device_span`) counts by
that interval, not by its host time: ``train.step`` then makes
``compute`` the time the card ran the step, with no synchronisation in
the traced run.
"""

from __future__ import annotations

__all__ = [
    "STAGES",
    "attribution",
    "format_report",
]

#: Attribution priority, highest first. Event categories not listed fold
#: into ``other``.
STAGES = (
    "compute",   # train_step on the consumer thread
    "stage",     # host->device staging + consumer wait on staged batches
    "ring",      # shared-memory ring write/read (incl. consumer poll wait)
    "decode",    # record decode + grid/pack assembly
    "read",      # storage chunk reads + residency claims
    "plan",      # clairvoyant epoch planning (encloses its shadow walk)
    "proto",     # protocol step walk (redirection bookkeeping)
    "service",   # multi-job pump rounds (enclose the work they drive)
)


def _intervals_by_stage(events) -> "dict[str, list[tuple[float, float]]]":
    by: "dict[str, list[tuple[float, float]]]" = {}
    for name, cat, ts, dur, tid, args in events:
        if dur < 0:
            continue  # instant events carry no duration
        if args and "dev_dur" in args:
            ts, dur = args["dev_ts"], args["dev_dur"]
        stage = cat if cat in STAGES else "other"
        by.setdefault(stage, []).append((ts, ts + dur))
    return by


def _union_seconds(intervals: "list[tuple[float, float]]") -> float:
    total, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in sorted(intervals):
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def attribution(events, *, wall_s: "float | None" = None) -> dict:
    """Fold trace events into the per-stage breakdown.

    ``events`` are :meth:`repro.obs.Tracer.events` tuples. ``wall_s``
    overrides the epoch wall time (defaults to the trace extent — pass the
    measured wall when the trace covers only part of the run).
    """
    by = _intervals_by_stage(events)
    all_iv = [iv for ivs in by.values() for iv in ivs]
    if not all_iv:
        return {
            "wall_s": float(wall_s or 0.0), "busy_s": {}, "exclusive_s": {},
            "idle_s": float(wall_s or 0.0), "spans": 0,
        }
    t_lo = min(lo for lo, _ in all_iv)
    t_hi = max(hi for _, hi in all_iv)
    wall = float(wall_s) if wall_s is not None else t_hi - t_lo

    busy = {stage: _union_seconds(ivs) for stage, ivs in by.items()}

    # Sweep-line exclusive decomposition: at each elementary interval the
    # highest-priority active stage claims the time.
    order = {s: i for i, s in enumerate(STAGES)}
    order["other"] = len(STAGES)
    points: "list[tuple[float, int, int]]" = []  # (t, +1/-1, stage_rank)
    for stage, ivs in by.items():
        rank = order[stage]
        for lo, hi in ivs:
            points.append((lo, rank, 1))
            points.append((hi, rank, -1))
    points.sort()
    ranks = list(order)
    active = [0] * (len(STAGES) + 1)
    exclusive = dict.fromkeys(by, 0.0)
    prev_t = None
    for t, rank, delta in points:
        if prev_t is not None and t > prev_t:
            for r in range(len(active)):
                if active[r]:
                    exclusive[ranks[r]] = (
                        exclusive.get(ranks[r], 0.0) + t - prev_t
                    )
                    break
        active[rank] += delta
        prev_t = t
    covered = sum(exclusive.values())
    return {
        "wall_s": wall,
        "busy_s": busy,
        "exclusive_s": exclusive,
        "idle_s": max(0.0, wall - covered),
        "spans": len(all_iv),
    }


def format_report(att: dict, *, measured_wall_s: "float | None" = None) -> str:
    """Render the attribution as a table."""
    wall = measured_wall_s if measured_wall_s is not None else att["wall_s"]
    lines = [
        f"epoch wall time: {wall:.3f}s "
        f"(trace extent {att['wall_s']:.3f}s, {att['spans']} spans)",
        f"{'stage':<10} {'busy_s':>9} {'excl_s':>9} {'excl_%':>7}",
    ]
    stages = [s for s in (*STAGES, "other") if s in att["busy_s"]]
    for stage in stages:
        excl = att["exclusive_s"].get(stage, 0.0)
        row = (
            f"{stage:<10} {att['busy_s'][stage]:>9.3f} {excl:>9.3f} "
            f"{100.0 * excl / wall if wall else 0.0:>6.1f}%"
        )
        lines.append(row)
    idle = att["idle_s"]
    lines.append(
        f"{'idle':<10} {'':>9} {idle:>9.3f} "
        f"{100.0 * idle / wall if wall else 0.0:>6.1f}%"
    )
    covered = sum(att["exclusive_s"].values()) + idle
    lines.append(
        f"attributed (exclusive + idle): {covered:.3f}s "
        f"of {att['wall_s']:.3f}s trace extent"
    )
    return "\n".join(lines)
