"""Model-fitted autotuning: calibrate storage, pick the data-plane config.

"Predictive Modeling of I/O Performance" (PAPERS.md) applied to this
repo's own §6 pipeline model (DESIGN.md §6/§14): a short **calibration
run** measures, per storage backend, what the model needs —

* **read bandwidth + chunk latency** — each sampled chunk read is timed;
  a least-squares fit of time against bytes gives ``1/bandwidth`` (slope)
  and the per-read ``chunk_overhead`` (intercept);
* **file overhead** — timed per-file ranged reads minus their bandwidth
  cost (the small-file penalty batching amortises);
* **decode rate** — bytes/s of turning raw chunk records into arrays
  (the host-side cost the loader overlaps).

:func:`fit_time_model` folds a profile into a
:class:`~repro.core.stats.PipelineTimeModel`; :func:`select_config` then
*predicts* the epoch time of every candidate ``(backend, readahead)``
pair against a per-step I/O demand profile and returns the argmin as a
:class:`TuneChoice` — including the cache byte cap
(:func:`required_cache_bytes`: the exact residency peak of a claim
schedule under release-on-last-claim caching, i.e. the smallest cap that
never forces an eviction) and, on progressive stores, the fidelity
prefix to read (:func:`select_fidelity`: full fidelity when the model
predicts compute-bound, a truncated band prefix when I/O-bound). Both
launchers expose this as ``--autotune``;
the measured storage bandwidth also feeds the service's admission control
(``repro.service.AdmissionControl``).

Synchronous backends are scored with the strict (no-overlap) epoch bound;
async backends interpolate between strict and pipelined by how much of the
per-step load burst their readahead depth covers — deeper readahead only
helps until it covers the burst, which is what makes the depth choice
well-posed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from pathlib import Path

import numpy as np

from .core.stats import PipelineTimeModel, StepIO
from .core.storage import BACKENDS, ChunkStore

__all__ = [
    "BackendProfile",
    "Calibration",
    "TuneChoice",
    "calibrate",
    "fit_time_model",
    "plan_step_io",
    "required_cache_bytes",
    "select_config",
    "select_fidelity",
    "tune_store",
    "uniform_step_io",
]

#: Nominal network profile used when the deployment's fabric is not
#: measured (single-box runs never touch it: net terms are zero).
DEFAULT_NET_BW = 1e9
DEFAULT_NET_LATENCY = 2e-4


@dataclasses.dataclass(frozen=True)
class BackendProfile:
    """One backend's fitted read-cost parameters (times in seconds)."""

    backend: str
    bandwidth_bytes_per_s: float
    chunk_overhead_s: float
    file_overhead_s: float
    samples: int

    def read_time(self, nbytes: int) -> float:
        return self.chunk_overhead_s + nbytes / self.bandwidth_bytes_per_s


@dataclasses.dataclass
class Calibration:
    """Everything a calibration run measured, JSON round-trippable."""

    backends: "dict[str, BackendProfile]"
    decode_bytes_per_s: float
    chunk_bytes_mean: float

    def to_dict(self) -> dict:
        return {
            "backends": {
                name: dataclasses.asdict(p) for name, p in self.backends.items()
            },
            "decode_bytes_per_s": self.decode_bytes_per_s,
            "chunk_bytes_mean": self.chunk_bytes_mean,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Calibration":
        return cls(
            backends={
                name: BackendProfile(**p) for name, p in d["backends"].items()
            },
            decode_bytes_per_s=d["decode_bytes_per_s"],
            chunk_bytes_mean=d["chunk_bytes_mean"],
        )

    def save(self, path: "str | Path") -> Path:
        path = Path(path)
        path.write_text(json.dumps(self.to_dict(), indent=2))
        return path

    @classmethod
    def load(cls, path: "str | Path") -> "Calibration":
        return cls.from_dict(json.loads(Path(path).read_text()))


@dataclasses.dataclass(frozen=True)
class TuneChoice:
    """The autotuner's selected data-plane configuration."""

    backend: str
    readahead: int                      # 0: backend has no readahead
    cache_limit_bytes: "int | None"
    predicted_epoch_s: float
    model: PipelineTimeModel            # the fitted §6 model it was scored with
    #: Fidelity bands to read from a progressive store (None: store is
    #: flat, or full fidelity — see :func:`select_fidelity`).
    fidelity: "int | None" = None

    def describe(self) -> str:
        cap = (
            "uncapped" if self.cache_limit_bytes is None
            else f"{self.cache_limit_bytes / 1e6:.1f} MB cap"
        )
        ra = f", readahead {self.readahead}" if self.readahead else ""
        fid = f", fidelity {self.fidelity}" if self.fidelity is not None else ""
        return (
            f"backend={self.backend}{ra}, cache {cap}{fid}, "
            f"predicted epoch {self.predicted_epoch_s:.3f}s "
            f"(disk {self.model.disk_bw / 1e6:.0f} MB/s, "
            f"chunk {self.model.chunk_overhead * 1e3:.2f} ms)"
        )


def _fit_linear(xs: np.ndarray, ts: np.ndarray) -> "tuple[float, float]":
    """(bandwidth, overhead) from per-read (bytes, seconds) samples.

    Degenerate inputs (near-uniform chunk sizes make the slope
    unidentifiable) fall back to the aggregate ratio with zero overhead —
    still the right *ranking* signal between backends.
    """
    total_bw = float(xs.sum() / max(ts.sum(), 1e-12))
    if len(xs) >= 2 and float(xs.std()) > 0.01 * float(xs.mean()):
        slope, intercept = np.polyfit(xs.astype(float), ts.astype(float), 1)
        if slope > 0:
            return min(1.0 / slope, 1e12), max(float(intercept), 0.0)
    return total_bw, 0.0


def calibrate(
    root: "str | Path",
    *,
    backends: "list[str] | None" = None,
    sample_chunks: int = 24,
    sample_files: int = 16,
    repeats: int = 2,
    seed: int = 0,
) -> Calibration:
    """Measure every candidate backend on the chunk store at ``root``.

    Reads a spread sample of chunks ``repeats`` times (per-read minimum is
    kept — the page cache makes the *minimum* the repeatable signal) and
    fits each backend's :class:`BackendProfile`. One short pass per
    backend: a few dozen reads, well under a second on local storage.
    """
    root = Path(root)
    names = list(backends) if backends is not None else sorted(BACKENDS)
    rng = np.random.default_rng(seed)
    profiles: "dict[str, BackendProfile]" = {}
    decode_rate, chunk_bytes_mean = 0.0, 0.0
    for name in names:
        store = ChunkStore.open(root, backend=name)
        try:
            plan = store.plan
            n = int(plan.num_chunks)
            ids = sorted(rng.choice(n, size=min(sample_chunks, n), replace=False))
            sizes = np.asarray([int(plan.chunk_bytes[k]) for k in ids], float)
            best = np.full(len(ids), np.inf)
            decoded_bytes, decode_s = 0, 0.0
            for _ in range(max(repeats, 1)):
                for j, k in enumerate(ids):
                    t0 = time.perf_counter()
                    records = store.read_chunk(int(k))
                    best[j] = min(best[j], time.perf_counter() - t0)
                    t1 = time.perf_counter()
                    for _fid, blob in records:
                        decoded_bytes += np.frombuffer(blob, np.uint8).size
                    decode_s += time.perf_counter() - t1
            bw, chunk_ovh = _fit_linear(sizes, best)
            # file_overhead: timed ranged per-file reads minus bandwidth cost
            fids = rng.choice(
                int(plan.num_files), size=min(sample_files, int(plan.num_files)),
                replace=False,
            )
            fbytes, ft = 0, 0.0
            for f in fids:
                t0 = time.perf_counter()
                fbytes += len(store.read_file(int(f)))
                ft += time.perf_counter() - t0
            file_ovh = max(ft - fbytes / bw, 0.0) / max(len(fids), 1)
            profiles[name] = BackendProfile(
                backend=name,
                bandwidth_bytes_per_s=bw,
                chunk_overhead_s=chunk_ovh,
                file_overhead_s=file_ovh,
                samples=len(ids),
            )
            decode_rate = max(
                decode_rate, decoded_bytes / decode_s if decode_s > 0 else 0.0
            )
            chunk_bytes_mean = float(np.asarray(plan.chunk_bytes).mean())
        finally:
            store.close()
    return Calibration(
        backends=profiles,
        decode_bytes_per_s=decode_rate,
        chunk_bytes_mean=chunk_bytes_mean,
    )


def fit_time_model(
    calib: Calibration,
    backend: str,
    *,
    net_bw: float = DEFAULT_NET_BW,
    net_latency: float = DEFAULT_NET_LATENCY,
) -> PipelineTimeModel:
    """A §6 :class:`PipelineTimeModel` from one backend's measured profile."""
    p = calib.backends[backend]
    return PipelineTimeModel(
        disk_bw=p.bandwidth_bytes_per_s,
        file_overhead=p.file_overhead_s,
        chunk_overhead=p.chunk_overhead_s,
        net_bw=net_bw,
        net_latency=net_latency,
    )


def required_cache_bytes(claims: "list[int]", chunk_bytes) -> int:
    """Exact residency peak of a claim schedule under first-to-last-claim
    caching — the smallest ``cache_limit_bytes`` that never evicts.

    Under release-on-last-claim refcounts (``SharedResidency`` with plans
    installed) a chunk occupies cache exactly over the interval from its
    first claim to its last; the peak of the interval-overlap byte count is
    therefore both achievable (Belady never evicts below it) and minimal
    (at the peak instant every resident byte has a future claim).
    """
    chunk_bytes = np.asarray(chunk_bytes)
    first: "dict[int, int]" = {}
    last: "dict[int, int]" = {}
    for i, k in enumerate(claims):
        k = int(k)
        first.setdefault(k, i)
        last[k] = i
    cur = peak = 0
    for i, k in enumerate(claims):
        k = int(k)
        if first[k] == i:
            cur += int(chunk_bytes[k])
            peak = max(peak, cur)
        if last[k] == i:
            cur -= int(chunk_bytes[k])
    return peak


def plan_step_io(plan, chunk_bytes) -> "list[StepIO]":
    """Per-step I/O demand of one :class:`EpochPlan` (tail step included)."""
    chunk_bytes = np.asarray(chunk_bytes)
    steps = []
    depth = plan.num_steps + (1 if plan.has_tail else 0)
    for s in range(depth):
        lo, hi = plan.load_range(s)
        ks = plan.load_chunk[lo:hi]
        steps.append(StepIO(
            chunk_loads=int(len(ks)),
            disk_bytes=int(chunk_bytes[ks].sum()) if len(ks) else 0,
        ))
    return steps


def uniform_step_io(
    total_bytes: int, num_chunks: int, num_steps: int
) -> "list[StepIO]":
    """Plan-free demand profile: the dataset read exactly once (the Redox
    invariant), spread evenly over ``num_steps`` — what a launcher can
    predict before any session is opened."""
    num_steps = max(int(num_steps), 1)
    per_bytes = int(total_bytes) // num_steps
    loads = max(num_chunks // num_steps, 1)
    return [
        StepIO(chunk_loads=loads, disk_bytes=per_bytes)
        for _ in range(num_steps)
    ]


def select_fidelity(
    model: PipelineTimeModel,
    step_io: "list[StepIO]",
    compute_per_step_s: float,
    bands: int,
) -> int:
    """How many fidelity bands of a progressive store to read (§6 model).

    Paper §6 applied to progressive records (PAPERS.md, "Progressive
    Compressed Records"): when the model predicts the job is
    *compute-bound* (per-epoch I/O time fits under the compute time)
    truncation buys nothing — return ``bands`` (full fidelity). When it
    predicts *I/O-bound*, pick the largest prefix whose proportionally
    shrunk read time fits the compute budget: I/O time scales ~linearly
    with the byte prefix, so ``fidelity ≈ bands * compute/io``, floored
    at one band so the epoch stream stays well-formed.
    """
    bands = max(int(bands), 1)
    if bands == 1:
        return 1
    io = model.epoch_time_strict([list(step_io)], 0.0)
    compute = compute_per_step_s * len(step_io)
    if io <= compute or io <= 0:
        return bands
    return max(1, min(bands, math.ceil(bands * compute / io)))


def select_config(
    calib: Calibration,
    step_io: "list[StepIO]",
    *,
    compute_per_step_s: float = 0.0,
    backends: "list[str] | None" = None,
    readahead_grid: "tuple[int, ...]" = (2, 4, 8, 16),
    claims: "list[int] | None" = None,
    chunk_bytes=None,
    memory_limit_bytes: "int | None" = None,
    bands: int = 1,
    net_bw: float = DEFAULT_NET_BW,
    net_latency: float = DEFAULT_NET_LATENCY,
) -> TuneChoice:
    """Predict every candidate config's epoch time; return the argmin.

    Synchronous backends are scored ``epoch_time_strict`` (every read
    blocks the step). Async backends overlap reads with compute, but only
    as far as their readahead depth covers the per-step load burst:
    coverage ``f = min(1, depth / max_step_loads)`` interpolates between
    the strict and pipelined bounds. Ties prefer the shallower depth
    (less readahead memory).

    The cache cap is :func:`required_cache_bytes` of ``claims`` when a
    claim schedule is known (clamped to ``memory_limit_bytes``), else
    ``memory_limit_bytes`` as given.

    With ``bands > 1`` (a progressive store) the winning choice also
    carries a :func:`select_fidelity` decision against its own fitted
    model — full fidelity when compute-bound, a truncated prefix when
    I/O-bound.
    """
    if not step_io:
        raise ValueError("select_config needs a non-empty per-step demand")
    names = list(backends) if backends is not None else sorted(calib.backends)
    grid = list(step_io)
    burst = max(s.chunk_loads for s in grid) or 1
    best: "TuneChoice | None" = None
    for name in names:
        model = fit_time_model(
            calib, name, net_bw=net_bw, net_latency=net_latency
        )
        strict = model.epoch_time_strict([grid], compute_per_step_s)
        pipelined = model.epoch_time([grid], compute_per_step_s)
        is_async = getattr(BACKENDS[name], "wants_prefetch", False)
        depths = tuple(readahead_grid) if is_async else (0,)
        for depth in depths:
            f = min(1.0, depth / burst) if is_async else 0.0
            predicted = strict - f * (strict - pipelined)
            if best is None or predicted < best.predicted_epoch_s - 1e-12:
                cap = None
                if claims is not None and chunk_bytes is not None:
                    cap = required_cache_bytes(claims, chunk_bytes)
                    if memory_limit_bytes is not None:
                        cap = min(cap, memory_limit_bytes)
                elif memory_limit_bytes is not None:
                    cap = memory_limit_bytes
                best = TuneChoice(
                    backend=name, readahead=depth, cache_limit_bytes=cap,
                    predicted_epoch_s=predicted, model=model,
                )
    if bands > 1 and best is not None:
        best = dataclasses.replace(
            best,
            fidelity=select_fidelity(
                best.model, grid, compute_per_step_s, bands
            ),
        )
    return best


def tune_store(
    root: "str | Path",
    *,
    compute_per_step_s: float = 0.0,
    memory_limit_bytes: "int | None" = None,
    num_steps: "int | None" = None,
    backends: "list[str] | None" = None,
    readahead_grid: "tuple[int, ...]" = (2, 4, 8, 16),
) -> "tuple[Calibration, TuneChoice]":
    """Calibrate the store at ``root`` and select a config against the
    plan-free uniform demand profile (the launcher entry point — both
    ``--autotune`` flags route through here)."""
    calib = calibrate(root, backends=backends)
    probe = ChunkStore.open(root)
    try:
        plan, bands = probe.plan, probe.spec.bands
    finally:
        probe.close()
    total = int(np.asarray(plan.chunk_bytes).sum())
    steps = int(num_steps) if num_steps else int(plan.num_chunks)
    choice = select_config(
        calib,
        uniform_step_io(total, int(plan.num_chunks), steps),
        compute_per_step_s=compute_per_step_s,
        backends=backends,
        readahead_grid=readahead_grid,
        memory_limit_bytes=memory_limit_bytes,
        bands=bands,
    )
    return calib, choice


def main(argv=None) -> int:
    """``python -m repro.autotune ROOT`` — calibrate a store and print the
    fitted profiles plus the selected configuration."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", help="chunk store directory (plan.npz inside)")
    ap.add_argument("--compute-per-step", type=float, default=0.0,
                    help="seconds of compute per training step (0: I/O bound)")
    ap.add_argument("--steps", type=int, default=0,
                    help="steps per epoch for the demand profile "
                         "(default: one chunk load per step)")
    ap.add_argument("--memory-mb", type=float, default=None,
                    help="cache budget ceiling in MB")
    ap.add_argument("--save", default=None, metavar="JSON",
                    help="write the calibration to this file")
    args = ap.parse_args(argv)
    calib, choice = tune_store(
        args.root,
        compute_per_step_s=args.compute_per_step,
        num_steps=args.steps or None,
        memory_limit_bytes=(
            int(args.memory_mb * 1e6) if args.memory_mb is not None else None
        ),
    )
    for name in sorted(calib.backends):
        p = calib.backends[name]
        print(f"{name:9s} bw {p.bandwidth_bytes_per_s / 1e6:9.1f} MB/s  "
              f"chunk {p.chunk_overhead_s * 1e3:6.3f} ms  "
              f"file {p.file_overhead_s * 1e3:6.3f} ms  ({p.samples} samples)")
    print(f"decode    {calib.decode_bytes_per_s / 1e6:9.1f} MB/s")
    print("selected:", choice.describe())
    if args.save:
        print("calibration ->", calib.save(args.save))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
