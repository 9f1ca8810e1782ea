"""Clairvoyant epoch planner: the *plan* half of the plan/execute split.

The Redox protocol is deterministic given its per-epoch RNG, and the
per-epoch access sequences are pre-shared across nodes (paper §3.4) — so
the entire epoch's I/O is computable before the first byte is read: every
refill chunk and its fill rate, every redirected return, every remote round
trip, every opportunistic ship. NoPFS (clairvoyant prefetching) and
FanStore (metadata/plan layer over a bulk-data layer) motivate exploiting
that, see PAPERS.md.

:class:`EpochPlanner` runs the protocol in id-space on a store-less
:meth:`Cluster.planning_clone` through the batched step engine
(``Cluster.access_step`` / ``LocalNode.request_step`` — NumPy batch
operations over whole steps; per-event Python only where an RNG draw or a
network round trip genuinely serialises the walk) and records the event
stream into an :class:`EpochPlan`. The plan is then *executed* by
``Cluster.replay_stream`` — which also hands the exact global chunk-read
schedule to the storage backend (``ChunkStore.schedule_reads``), replacing
the ``_refill_hints`` heuristic with clairvoyant readahead — or simply
queried (benchmarks price its StepIO records through the time model).

Equivalence to the live per-access walk — same returned stream, same chunk
loads, same counters — is asserted in ``tests/test_planner.py``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.obs import tracer as trace

from .distributed import Cluster
from .sampler import EpochSampler
from .stats import NodeStats, PlannerStats, StepIO

__all__ = ["EpochPlan", "EpochPlanner", "PlanRecorder"]

_IO_FIELDS = ("chunk_loads", "disk_bytes", "file_reads", "net_messages", "net_bytes")


class PlanRecorder:
    """Collects protocol events while a (shadow) cluster walks an epoch.

    Hooked into ``LocalNode._load_chunk`` (chunk-load events) and
    ``Cluster._opportunistic_prefetch`` (ship events) via
    ``Cluster.set_recorder``; the epoch driver reports step boundaries,
    returned ids, and per-step I/O. Works identically under the batched and
    the per-access engines, which is what lets the equivalence tests compare
    their event streams directly.
    """

    def __init__(self) -> None:
        self.step = 0
        self.load_step: list[int] = []
        self.load_owner: list[int] = []
        self.load_chunk: list[int] = []
        self.load_fill_rate: list[float] = []
        self.load_files: list[np.ndarray] = []
        self.ship_step: list[int] = []
        self.ship_src: list[int] = []
        self.ship_dst: list[int] = []
        self.ship_file: list[int] = []
        self.ship_loc: list[int] = []
        self.returned: list[list[np.ndarray]] = []  # [step][node]
        self.step_io: list[dict[int, StepIO]] = []

    # ------------------------------------------------------------- callbacks
    def begin_step(self, step: int) -> None:
        self.step = step

    def end_step(
        self, step: int, returned: list[np.ndarray], io_by_node: dict[int, StepIO]
    ) -> None:
        assert step == len(self.returned)
        self.returned.append(returned)
        self.step_io.append(
            {r: dataclasses.replace(io) for r, io in io_by_node.items()}
        )

    def on_load(
        self, owner: int, chunk: int, fill_rate: float, files: np.ndarray
    ) -> None:
        self.load_step.append(self.step)
        self.load_owner.append(owner)
        self.load_chunk.append(chunk)
        self.load_fill_rate.append(fill_rate)
        self.load_files.append(np.asarray(files, dtype=np.int64))

    def on_ship(self, src: int, dst: int, file_id: int, loc: int) -> None:
        self.ship_step.append(self.step)
        self.ship_src.append(src)
        self.ship_dst.append(dst)
        self.ship_file.append(file_id)
        self.ship_loc.append(loc)


@dataclasses.dataclass
class EpochPlan:
    """The pre-computed I/O schedule of one epoch (id-space, no bytes).

    Everything is stored as flat NumPy arrays in global event order; the
    ``*_range`` helpers slice them per training step for replay. When the
    plan was built with ``stepping="floor_tail"`` the final pseudo-step
    (index ``num_steps``) holds the ragged-tail drain that the loader
    consumes but never yields.
    """

    epoch: int
    batch_per_node: int
    num_nodes: int
    stepping: str
    num_steps: int               # yielded training steps
    has_tail: bool               # extra drain pseudo-step recorded at the end

    # per-node returned files: flat consumption order + per-step offsets
    returned_flat: list[np.ndarray]
    returned_offsets: list[np.ndarray]

    # chunk-load events, global order == the exact chunk-read schedule
    load_step: np.ndarray
    load_owner: np.ndarray
    load_chunk: np.ndarray
    load_fill_rate: np.ndarray
    load_files_flat: np.ndarray
    load_files_offsets: np.ndarray

    # opportunistic prefetch ships, global order
    ship_step: np.ndarray
    ship_src: np.ndarray
    ship_dst: np.ndarray
    ship_file: np.ndarray
    ship_loc: np.ndarray

    # per-(step, node) StepIO counter grid, shape (num_steps [+1], num_nodes)
    io_grid: np.ndarray
    io_nodes_present: np.ndarray  # bool grid: live walk created an entry

    node_stats: list[NodeStats]   # exact end-of-epoch protocol counters
    # Elastic extensions: a *suffix* plan (EpochPlanner.plan_from) covers the
    # epoch from ``start_step`` on (its arrays are indexed relative to that);
    # ``joined_nodes`` counts nodes admitted mid-epoch by a ``joins``
    # schedule, so replay can grow matching shells.
    start_step: int = 0
    joined_nodes: int = 0
    stats: PlannerStats = dataclasses.field(default_factory=PlannerStats)

    # ------------------------------------------------------------ accessors
    @property
    def chunk_schedule(self) -> np.ndarray:
        """The exact global chunk-read schedule, in read order."""
        return self.load_chunk

    def load_range(self, step: int) -> tuple[int, int]:
        return (
            int(np.searchsorted(self.load_step, step, side="left")),
            int(np.searchsorted(self.load_step, step, side="right")),
        )

    def ship_range(self, step: int) -> tuple[int, int]:
        return (
            int(np.searchsorted(self.ship_step, step, side="left")),
            int(np.searchsorted(self.ship_step, step, side="right")),
        )

    def load_files(self, li: int) -> np.ndarray:
        """Files the ``li``-th chunk load merges into abstract memory."""
        return self.load_files_flat[
            self.load_files_offsets[li] : self.load_files_offsets[li + 1]
        ]

    def step_returned(self, step: int) -> list[np.ndarray]:
        """Per-node returned file ids of ``step``, in consumption order."""
        return [
            self.returned_flat[r][
                self.returned_offsets[r][step] : self.returned_offsets[r][step + 1]
            ]
            for r in range(self.num_nodes)
        ]

    def step_io(self, step: int) -> dict[int, StepIO]:
        """Fresh StepIO objects reproducing the live walk's ``io_by_node``."""
        out: dict[int, StepIO] = {}
        for r in range(self.num_nodes):
            if not self.io_nodes_present[step, r]:
                continue
            vals = self.io_grid[step, r]
            out[r] = StepIO(**{f: int(v) for f, v in zip(_IO_FIELDS, vals)})
        return out

    @staticmethod
    def from_recorder(
        rec: "PlanRecorder",
        *,
        epoch: int,
        batch_per_node: int,
        num_nodes: int,
        stepping: str,
        num_steps: int,
        node_stats: "list[NodeStats]",
        start_step: int = 0,
        joined_nodes: int = 0,
    ) -> "EpochPlan":
        """Assemble a plan from a recorded epoch walk.

        Shared by :class:`EpochPlanner` (solo shadow walk) and the data
        service's joint planner (``repro/service``), which interleaves many
        shadow clusters and therefore drives the streams itself. A node
        joined mid-walk has no entries in the pre-join steps; its rows are
        padded with empty returns there (matching the live driver's grid).
        """
        has_tail = len(rec.returned) > num_steps
        none = np.empty(0, dtype=np.int64)

        returned_flat, returned_offsets = [], []
        for r in range(num_nodes):
            per_step = [s[r] if r < len(s) else none for s in rec.returned]
            offs = np.zeros(len(per_step) + 1, dtype=np.int64)
            np.cumsum([p.size for p in per_step], out=offs[1:])
            returned_flat.append(
                np.concatenate(per_step) if per_step else np.empty(0, np.int64)
            )
            returned_offsets.append(offs)

        file_counts = [f.size for f in rec.load_files]
        load_files_offsets = np.zeros(len(file_counts) + 1, dtype=np.int64)
        np.cumsum(file_counts, out=load_files_offsets[1:])

        io_grid = np.zeros(
            (len(rec.step_io), num_nodes, len(_IO_FIELDS)), dtype=np.int64
        )
        io_present = np.zeros((len(rec.step_io), num_nodes), dtype=bool)
        for s, io_by_node in enumerate(rec.step_io):
            for r, io in io_by_node.items():
                io_present[s, r] = True
                io_grid[s, r] = [getattr(io, f) for f in _IO_FIELDS]

        plan = EpochPlan(
            epoch=epoch,
            batch_per_node=batch_per_node,
            num_nodes=num_nodes,
            stepping=stepping,
            num_steps=num_steps,
            has_tail=has_tail,
            returned_flat=returned_flat,
            returned_offsets=returned_offsets,
            load_step=np.asarray(rec.load_step, dtype=np.int64),
            load_owner=np.asarray(rec.load_owner, dtype=np.int64),
            load_chunk=np.asarray(rec.load_chunk, dtype=np.int64),
            load_fill_rate=np.asarray(rec.load_fill_rate, dtype=np.float64),
            load_files_flat=(
                np.concatenate(rec.load_files)
                if rec.load_files else np.empty(0, np.int64)
            ),
            load_files_offsets=load_files_offsets,
            ship_step=np.asarray(rec.ship_step, dtype=np.int64),
            ship_src=np.asarray(rec.ship_src, dtype=np.int64),
            ship_dst=np.asarray(rec.ship_dst, dtype=np.int64),
            ship_file=np.asarray(rec.ship_file, dtype=np.int64),
            ship_loc=np.asarray(rec.ship_loc, dtype=np.int64),
            io_grid=io_grid,
            io_nodes_present=io_present,
            node_stats=[s.copy() for s in node_stats],
            start_step=start_step,
            joined_nodes=joined_nodes,
        )
        plan.stats = PlannerStats(
            planned_steps=num_steps,
            planned_accesses=sum(int(f.size) for f in returned_flat),
            planned_chunk_loads=int(plan.load_chunk.size),
            planned_ships=int(plan.ship_file.size),
        )
        return plan

    def validate(
        self,
        cluster: Cluster,
        epoch: int | None = None,
        batch_per_node: int | None = None,
        stepping: str | None = None,
    ) -> None:
        """Refuse to replay under a different grid than the plan was cut for."""
        if cluster.num_nodes != self.num_nodes:
            raise ValueError(
                f"plan is for {self.num_nodes} nodes, cluster has {cluster.num_nodes}"
            )
        if epoch is not None and epoch != self.epoch:
            raise ValueError(f"plan is for epoch {self.epoch}, asked to replay {epoch}")
        if batch_per_node is not None and batch_per_node != self.batch_per_node:
            raise ValueError(
                f"plan was computed for batch_per_node={self.batch_per_node}, "
                f"asked to replay with {batch_per_node}"
            )
        if stepping is not None and stepping != self.stepping:
            raise ValueError(
                f"plan uses {self.stepping!r} stepping, replay expects {stepping!r}"
            )


class EpochPlanner:
    """Computes :class:`EpochPlan` objects for a live cluster.

    The planner never touches the live cluster's state: it simulates on a
    fresh store-less clone with identical configuration. Per-epoch RNG
    derivation makes the clone's epoch-``e`` walk bit-identical to the live
    cluster's, independent of execution history — the paper's determinism
    argument (§3.4) turned into an artifact.
    """

    def __init__(self, cluster: Cluster):
        self.cluster = cluster

    def plan(
        self,
        sampler: EpochSampler,
        epoch: int,
        batch_per_node: int,
        *,
        stepping: str = "ceil",
        failures: "dict[int, int] | None" = None,
        joins: "dict[int, int] | None" = None,
    ) -> EpochPlan:
        t0 = time.perf_counter()
        shadow = self.cluster.planning_clone()
        initial_nodes = shadow.num_nodes
        rec = PlanRecorder()
        steps = 0
        for step, _, _, _ in shadow.epoch_stream(
            sampler, epoch, batch_per_node,
            stepping=stepping, recorder=rec, failures=failures, joins=joins,
        ):
            steps = step + 1
        plan = EpochPlan.from_recorder(
            rec,
            epoch=epoch,
            batch_per_node=batch_per_node,
            num_nodes=shadow.num_nodes,
            stepping=stepping,
            num_steps=steps,
            node_stats=[n.stats for n in shadow.nodes],
            joined_nodes=shadow.num_nodes - initial_nodes,
        )
        plan.stats.plan_time_s = time.perf_counter() - t0
        tracer = trace.get()
        if tracer is not None:
            tracer.complete(
                "planner.plan", "plan", t0, plan.stats.plan_time_s,
                {"epoch": epoch, "steps": steps},
            )
        return plan

    def plan_from(
        self,
        snapshot,
        *,
        failures: "dict[int, int] | None" = None,
        joins: "dict[int, int] | None" = None,
    ) -> EpochPlan:
        """Re-plan the epoch *suffix* from a mid-epoch snapshot.

        A store-less shadow is restored from the snapshot and walked to the
        end of the epoch; the recorded events become a suffix
        :class:`EpochPlan` (``start_step = snapshot.step``, arrays indexed
        relative to it) that ``replay_stream`` executes — handing the
        backend exactly the *remaining* chunk-read schedule. Elastic-event
        schedules are keyed by absolute step, so passing the original
        ``failures``/``joins`` dicts replays the scenario's suffix events.
        """
        t0 = time.perf_counter()
        shadow = Cluster.restore(snapshot, plan=self.cluster.plan)
        initial_nodes = shadow.num_nodes
        batch = snapshot.grid.get("batch_per_node")
        stepping = snapshot.grid.get("stepping") or "ceil"
        assert batch is not None, "snapshot carries no step grid to re-plan on"
        rec = PlanRecorder()
        steps = 0
        for step, _, _, _ in shadow.epoch_stream(
            None, snapshot.epoch, batch,
            stepping=stepping, recorder=rec, failures=failures, joins=joins,
            start_step=snapshot.step, resume=True,
        ):
            steps = step - snapshot.step + 1
        plan = EpochPlan.from_recorder(
            rec,
            epoch=snapshot.epoch,
            batch_per_node=batch,
            num_nodes=shadow.num_nodes,
            stepping=stepping,
            num_steps=steps,
            node_stats=[n.stats for n in shadow.nodes],
            start_step=snapshot.step,
            joined_nodes=shadow.num_nodes - initial_nodes,
        )
        plan.stats.plan_time_s = time.perf_counter() - t0
        tracer = trace.get()
        if tracer is not None:
            tracer.complete(
                "planner.plan_from", "plan", t0, plan.stats.plan_time_s,
                {"epoch": snapshot.epoch, "start_step": snapshot.step,
                 "steps": steps},
            )
        return plan

    def state_at(
        self,
        sampler: EpochSampler,
        epoch: int,
        batch_per_node: int,
        step: int,
        *,
        stepping: str = "ceil",
        failures: "dict[int, int] | None" = None,
        joins: "dict[int, int] | None" = None,
    ):
        """The cluster's exact protocol state at the ``step`` barrier of
        ``epoch``, as a :class:`~repro.core.elastic.ClusterSnapshot` —
        computed on a store-less shadow (the live cluster is untouched).

        This is how a *replay* session suspends: its protocol state is
        implicit in the plan, so the snapshot is derived by simulating the
        prefix in id-space (per-epoch RNG derivation makes the shadow walk
        bit-identical to the live one)."""
        shadow = self.cluster.planning_clone()
        if step == 0:
            shadow.begin_epoch(sampler, epoch)
            shadow._grid = (batch_per_node, stepping)
            return shadow.snapshot(step=0)
        for s, _, _, _ in shadow.epoch_stream(
            sampler, epoch, batch_per_node,
            stepping=stepping, failures=failures, joins=joins,
        ):
            if s + 1 >= step:
                break
        return shadow.snapshot(step=step)
