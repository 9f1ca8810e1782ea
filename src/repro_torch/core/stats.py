"""Counters and the epoch-time pipeline model.

The protocol itself is deterministic given its RNG, so every quantity the
paper reports (Table 4/5, Fig. 12-14) is either an exact counter collected
here or a time derived from the counters through
:class:`PipelineTimeModel` (documented below, calibration in DESIGN.md §6).
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "DeviceStats",
    "NodeStats",
    "PipelineTimeModel",
    "PlannerStats",
    "ServiceStats",
    "StatsDict",
    "StepIO",
]


class StatsDict:
    """Round-trippable dict form for stats dataclasses.

    ``to_dict()`` emits the dataclass fields only (derived ``@property``
    ratios are recomputed on the way back in), so
    ``cls.from_dict(x.to_dict()) == x`` holds exactly. This is the one
    serialization every consumer shares: ``MetricsRegistry.collect()``,
    the transport stats/metrics RPCs, and the benchmark JSON records.
    """

    def to_dict(self) -> dict:
        return {
            f.name: getattr(self, f.name) for f in dataclasses.fields(self)
        }

    @classmethod
    def from_dict(cls, d: dict):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass
class NodeStats(StatsDict):
    """Exact per-node protocol counters for one epoch."""

    accesses: int = 0
    local_hits: int = 0            # served by a valid local abstract slot
    memory_misses: int = 0         # slot empty -> a chunk load was required
    chunk_loads: int = 0           # batched disk reads issued
    remote_requests: int = 0       # on-demand requests sent to an owner
    remote_prefetch_hits: int = 0  # served from the remote abstract memory
    prefetch_sent: int = 0         # files this node shipped as prefetch
    prefetch_received: int = 0

    disk_bytes: int = 0            # total bytes batched in from storage
    filled_bytes: int = 0          # bytes of those that landed in a slot
    wasted_bytes: int = 0          # disk_bytes - filled_bytes (paper fill_rate waste)
    net_bytes: int = 0             # on-demand + prefetch payload bytes
    net_messages: int = 0

    fill_rate_num: float = 0.0     # sum of fill_rate over chunk loads
    read_wait_s: float = 0.0       # wall time blocked on storage chunk reads
    peak_local_bytes: int = 0
    peak_remote_bytes: int = 0
    # Backend's max concurrent background reads. NB: the storage backend is
    # shared across nodes and epochs, so unlike the other peaks this mirrors
    # its store-lifetime high-water mark (identically in live and replay).
    peak_inflight_reads: int = 0

    @property
    def mean_fill_rate(self) -> float:
        return self.fill_rate_num / self.chunk_loads if self.chunk_loads else 1.0

    @property
    def read_throughput(self) -> float:
        """Observed chunk-read throughput: bytes batched in per blocked second."""
        return self.disk_bytes / self.read_wait_s if self.read_wait_s > 0 else 0.0

    def merge(self, other: "NodeStats") -> "NodeStats":
        out = NodeStats()
        for f in dataclasses.fields(NodeStats):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if f.name.startswith("peak"):
                setattr(out, f.name, max(a, b))
            else:
                setattr(out, f.name, a + b)
        return out

    def copy(self) -> "NodeStats":
        return dataclasses.replace(self)


@dataclasses.dataclass
class PlannerStats(StatsDict):
    """Counters for the clairvoyant plan/execute split (core/planner.py).

    ``scheduled_read_hits`` vs ``heuristic_prefetch_hits`` separates backend
    reads served by the planner's exact chunk schedule from those served by
    the ``_refill_hints`` heuristic readahead (the fallback when no plan is
    attached); the executing loader fills them in from the backend counters
    after the epoch.
    """

    plan_time_s: float = 0.0       # wall time to compute the EpochPlan
    planned_steps: int = 0         # training steps covered by the plan
    planned_accesses: int = 0      # total accesses scheduled
    planned_chunk_loads: int = 0   # exact chunk-read schedule length
    planned_ships: int = 0         # opportunistic prefetch ships scheduled
    scheduled_read_hits: int = 0   # backend reads served by the exact schedule
    heuristic_prefetch_hits: int = 0  # reads served by heuristic readahead


@dataclasses.dataclass
class ServiceStats(StatsDict):
    """Shared-residency counters for one job (or, merged, for a whole
    :class:`repro.service.DataService`).

    ``shared_hits`` are chunk claims served from the shared cache — each one
    is a duplicate disk read avoided (``dup_loads_avoided`` is the same
    quantity under the paper-facing name). ``physical_*`` are the reads that
    actually reached the storage backend on behalf of this job.

    On a compressed store (DESIGN.md §15) the cache holds compressed
    frames and every claim decodes its own copy, so the byte counters
    split: ``physical_bytes``/``shared_bytes``/``peak_cache_bytes`` count
    *physical* (compressed) bytes — what disk and cache capacity actually
    see — while ``logical_bytes`` counts the decoded bytes handed to
    sessions. Their ratio is the effective capacity multiplier the codec
    buys; ``decode_claims``/``decode_s`` price what it costs.
    """

    physical_reads: int = 0    # chunk reads that hit the storage backend
    physical_bytes: int = 0    # physical (on-disk, possibly compressed) bytes
    shared_hits: int = 0       # chunk claims served from the shared cache
    shared_bytes: int = 0      # physical bytes of those claims (reads avoided)
    logical_bytes: int = 0     # decoded record bytes handed to sessions
    decode_claims: int = 0     # claims that ran a per-claim frame decode
    decode_s: float = 0.0      # wall time spent in per-claim decodes
    co_refill_hits: int = 0    # refill choices steered by the co-refill hook
    evictions: int = 0         # cache-limit evictions (claims may re-read)
    cache_bypass: int = 0      # reads served but refused caching (cap pressure)
    peak_cache_bytes: int = 0  # high-water mark of shared cache residency

    @property
    def dup_loads_avoided(self) -> int:
        return self.shared_hits

    def merge(self, other: "ServiceStats") -> "ServiceStats":
        out = ServiceStats()
        for f in dataclasses.fields(ServiceStats):
            a, b = getattr(self, f.name), getattr(other, f.name)
            setattr(out, f.name, max(a, b) if f.name.startswith("peak") else a + b)
        return out

    def copy(self) -> "ServiceStats":
        return dataclasses.replace(self)


@dataclasses.dataclass
class StepIO(StatsDict):
    """Per-training-step I/O demand of one node (input to the time model)."""

    chunk_loads: int = 0
    disk_bytes: int = 0
    file_reads: int = 0   # per-file reads (baselines only; Redox never does these)
    net_messages: int = 0
    net_bytes: int = 0
    read_wait_s: float = 0.0  # *measured* storage stall (real-bytes runs only)
    # Host->device staging (DESIGN.md §12): wall time spent preparing and
    # shipping this step's device batch, and the slice of it the consumer
    # actually waited on (0 when staging was fully hidden behind compute).
    stage_s: float = 0.0
    stage_wait_s: float = 0.0

    def add(self, other: "StepIO") -> None:
        self.chunk_loads += other.chunk_loads
        self.disk_bytes += other.disk_bytes
        self.file_reads += other.file_reads
        self.net_messages += other.net_messages
        self.net_bytes += other.net_bytes
        self.read_wait_s += other.read_wait_s
        self.stage_s += other.stage_s
        self.stage_wait_s += other.stage_wait_s


@dataclasses.dataclass
class DeviceStats(StatsDict):
    """Host→device staging counters for one :class:`DeviceStager` stream.

    ``stage_s`` is wall time the staging thread spent assembling + shipping
    batches (decode/pack, the host→device copy, gather-kernel dispatch);
    ``wait_s`` is the consumer time actually blocked on a staged batch.
    Both are host clocks: how long the card itself waited is the
    ``stager.wait`` span against the device intervals of the trainer's
    spans (``bench/metrics/data.stall_share.py``). ``loss_tokens`` counts
    the loss-bearing tokens of the batches handed to the consumer, as the
    pack counts them on the host (``min(len, S+1) - 1`` a row).
    """

    steps: int = 0
    bytes_to_device: int = 0   # payload bytes shipped (slot buffers or grids)
    stage_s: float = 0.0       # staging-thread wall time
    wait_s: float = 0.0        # consumer wall time blocked on the queue
    kernel_steps: int = 0      # steps assembled on-device by chunk_gather
    buffers_released: int = 0  # staged-but-unconsumed batches freed at teardown
    loss_tokens: int = 0       # loss-bearing tokens handed to the consumer


@dataclasses.dataclass(frozen=True)
class PipelineTimeModel:
    """Double-buffered loader model.

    Every DL framework under test (PyTorch DataLoader with workers, CoorDL,
    Redox clients) overlaps data loading with compute, so the wall time of a
    step is ``max(compute, io)`` and epoch time is the per-step sum, maxed
    over nodes (data-parallel barrier at each step). I/O time of a step is

        io = file_reads * file_overhead + chunk_loads * chunk_overhead
           + disk_bytes / disk_bw + net_messages * net_latency
           + net_bytes / net_bw

    ``file_overhead`` is the per-small-file cost (metadata + head positioning
    on NAS) that batching amortises — the mechanism behind the paper's Fig. 13
    I/O-throughput gains. Calibration to the paper's Table 2 setups lives in
    ``benchmarks/calibration.py``.
    """

    disk_bw: float          # bytes/s sequential
    file_overhead: float    # s per individual small-file read
    chunk_overhead: float   # s per batched chunk read
    net_bw: float           # bytes/s
    net_latency: float      # s per message

    def io_time(self, io: StepIO) -> float:
        return (
            io.file_reads * self.file_overhead
            + io.chunk_loads * self.chunk_overhead
            + io.disk_bytes / self.disk_bw
            + io.net_messages * self.net_latency
            + io.net_bytes / self.net_bw
        )

    def epoch_time(
        self, per_node_step_io: list[list[StepIO]], compute_per_step: float
    ) -> float:
        """Pipelined bound: ``max_node (max(Σcompute, Σio) + pipeline fill)``.

        Loaders run ahead through a prefetch queue, so bursty chunk loads
        (which cluster at epoch start, when the abstract memory is empty)
        are smoothed across the epoch; only the first batch's I/O sits on
        the critical path. This matches the paper's own observation that
        Brand reaches No-I/O time for compute-heavy models (Fig. 10d). The
        strict no-queue model is kept as :meth:`epoch_time_strict`.
        """
        worst = 0.0
        for steps in per_node_step_io:
            total_io = sum(self.io_time(s) for s in steps)
            fill = self.io_time(steps[0]) if steps else 0.0
            t = max(compute_per_step * len(steps), total_io) + fill
            worst = max(worst, t)
        return worst

    def epoch_time_strict(
        self, per_node_step_io: list[list[StepIO]], compute_per_step: float
    ) -> float:
        """``max_node Σ_step max(compute, io_step)`` — no prefetch queue."""
        worst = 0.0
        for steps in per_node_step_io:
            t = sum(max(compute_per_step, self.io_time(s)) for s in steps)
            worst = max(worst, t)
        return worst
