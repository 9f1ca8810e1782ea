"""RedoxLoader: the bridge from the redirection protocol to JAX training.

This replaces the DL framework's *data fetcher* exactly as the paper does
for PyTorch (§4.2): the framework still generates its random per-epoch
sequence; the loader walks it, but every index is served through the Redox
protocol, so the batch contains *redirected* (still uniformly random,
exactly-once) records.

Batches are fixed-shape ``(batch, seq_len)`` int32 token grids with a loss
mask (documents are clipped/padded — standard LM practice), so the jitted
train step never recompiles.

Clairvoyant epochs (DESIGN.md §8): by default each epoch is *planned*
before it is executed — an :class:`EpochPlanner` simulates the protocol in
id-space (cheap NumPy batch work), and the epoch then replays the plan:
the storage backend receives the exact global chunk-read schedule
(``ChunkStore.schedule_reads``) so its readahead is prefetch-exact rather
than heuristic. ``use_planner=False`` restores the live walk (the
``_refill_hints`` heuristic drives readahead instead).

Straggler mitigation (DESIGN.md §5): an optional background prefetch queue
(`queue_depth`) runs the protocol walk (and its storage reads) ahead of
consumption on a worker thread, while decode + grid assembly happen on the
consumer side at ``__next__`` time — a two-stage pipeline. With a parallel
storage backend the chunk reads themselves also overlap, so a slow chunk
read or remote round trip only stalls training once the queue drains,
mirroring the paper's client/server split where clients hide server
latency.
"""

from __future__ import annotations

import json
import queue
import threading
from pathlib import Path

import numpy as np

from repro_torch.obs import tracer as trace

from ..data.tokens import decode_record
from .distributed import Cluster
from .elastic import ClusterSnapshot
from .planner import EpochPlanner
from .sampler import EpochSampler
from .spec import SessionSpec
from .stats import StepIO

__all__ = ["RedoxLoader", "GlobalBatch", "SessionSpec"]

LOADER_MANIFEST = "loader_manifest.json"


class GlobalBatch(dict):
    """dict with tokens/targets/loss_mask ndarrays (converted by the step fn)."""


def _to_grid(records: list[np.ndarray], seq_len: int, pad_id: int):
    """Clip/pad variable-length documents into a fixed (B, S) grid + mask."""
    b = len(records)
    tokens = np.full((b, seq_len), pad_id, dtype=np.int32)
    mask = np.zeros((b, seq_len), dtype=np.float32)
    for i, rec in enumerate(records):
        n = min(rec.shape[0], seq_len)
        tokens[i, :n] = rec[:n]
        mask[i, :n] = 1.0
    return tokens, mask


class RedoxLoader:
    """Iterator over global batches served by a (possibly 1-node) cluster."""

    def __init__(
        self,
        cluster: Cluster,
        sampler: EpochSampler,
        *,
        batch_per_node: int,
        seq_len: int,
        pad_id: int = 0,
        queue_depth: int = 2,
        use_planner: "bool | None" = None,
        engine: "str | None" = None,
    ):
        assert cluster.num_nodes == sampler.num_nodes
        if engine is None:
            # Back-compat spelling: use_planner=True/False maps to the
            # planned replay vs the batched live walk.
            engine = "replay" if (use_planner is None or use_planner) else "step"
        if engine not in ("replay", "step", "per_access"):
            raise ValueError(f"unknown loader engine {engine!r}")
        self.cluster = cluster
        self.sampler = sampler
        self.batch_per_node = batch_per_node
        self.seq_len = seq_len
        self.pad_id = pad_id
        self.queue_depth = queue_depth
        self.engine = engine
        self.last_plan = None       # EpochPlan of the most recent epoch
        self._worker: threading.Thread | None = None
        # Suspend/resume bookkeeping (DESIGN.md §10): the consumption cursor
        # (epoch, next step) advanced as batches are yielded, the underlying
        # step stream of a running sync epoch (closable by suspend), whether
        # the current epoch is consumed through epoch_async, and the pending
        # resume point installed by RedoxLoader.resume().
        self._progress: "tuple[int, int] | None" = None
        self._live_stream = None
        self._async_epoch = False
        self._resume: "dict | None" = None

    @property
    def use_planner(self) -> bool:
        return self.engine == "replay"

    @classmethod
    def from_spec(cls, spec: SessionSpec, store) -> "RedoxLoader":
        """Build the whole Cluster + EpochSampler + RedoxLoader stack from
        one :class:`~repro.core.spec.SessionSpec`.

        This is THE session constructor: ``DataService.open_session`` and
        the transport server both delegate here, so a spec means exactly
        the same stack everywhere (a single-session service run is
        byte-identical to ``RedoxLoader.from_spec(spec, store)``).
        """
        if spec.fidelity is not None:
            # Progressive decode (DESIGN.md §15): the session owns its
            # store handle (a real ChunkStore in-process, a per-session
            # _SessionStore facade under the service), so setting its
            # standing fidelity scopes truncation to this session.
            store.default_fidelity = spec.fidelity
        cluster = Cluster(
            store.plan,
            spec.num_nodes,
            policy=spec.policy,
            seed=spec.seed,
            store=store,
            prefetch=spec.prefetch,
            prefetch_window=spec.prefetch_window,
            remote_memory_limit_bytes=spec.remote_memory_limit_bytes,
        )
        sampler = EpochSampler(
            store.plan.num_files, spec.num_nodes, seed=spec.effective_sampler_seed
        )
        return cls(
            cluster,
            sampler,
            batch_per_node=spec.batch_per_node,
            seq_len=spec.seq_len,
            pad_id=spec.pad_id,
            queue_depth=spec.queue_depth,
            engine=spec.engine,
        )

    @property
    def spec(self) -> SessionSpec:
        """The SessionSpec this loader stack embodies (reconstructed from
        live state, so it is exact for ``from_spec``-built loaders and a
        best-effort description otherwise)."""
        return SessionSpec(
            policy=self.cluster.policy,
            seed=self.cluster.seed,
            sampler_seed=self.sampler.seed,
            num_nodes=self.cluster.num_nodes,
            batch_per_node=self.batch_per_node,
            seq_len=self.seq_len,
            pad_id=self.pad_id,
            engine=self.engine,
            prefetch=self.cluster.prefetch,
            prefetch_window=self.cluster.prefetch_window,
            remote_memory_limit_bytes=self.cluster._remote_limit,
            queue_depth=self.queue_depth,
            fidelity=getattr(self.cluster.store, "default_fidelity", None),
        )

    def steps_per_epoch(self, epoch: int = 0) -> int:
        n = min(len(s) for s in self.sampler.node_sequences(epoch))
        return n // self.batch_per_node

    # ------------------------------------------------------------- epochs
    def epoch(self, epoch: int, *, plan=None):
        """Yield GlobalBatch objects; runs protocol inline (deterministic)."""
        self._async_epoch = False
        produce = self._produce(epoch, plan=plan)
        self._live_stream = produce
        for item in produce:
            batch = self._assemble(*item)
            # Cursor advances as the batch is handed over: a consumer that
            # breaks right after this yield suspends at the next step.
            self._progress = (epoch, int(batch["step"]) + 1)
            yield batch

    def epoch_async(self, epoch: int, *, plan=None):
        """Same batches, two-stage pipeline (double-buffered).

        Stage 1 (worker thread): protocol walk + chunk reads — with a
        parallel backend these are themselves overlapped via readahead.
        Stage 2 (this thread): record decode + ``_to_grid`` assembly,
        running while the worker's next reads are in flight.

        If the consumer abandons the generator early (``break``, an
        exception, or explicit ``close()``), the worker is signalled to
        shut down and joined — it must never stay blocked on a full queue
        (the epoch's protocol state is then mid-flight; a later
        ``begin_epoch`` asserts on the undrained memory by design).
        """
        yield from self._pipelined(epoch, plan=plan, assemble=self._assemble)

    def epoch_device(self, epoch: int, stager=None, *, plan=None):
        """Device-resident batches (DESIGN.md §12): the host pipeline packs
        slot buffers instead of grids, and a :class:`~repro.core.device.
        DeviceStager` double-buffers ``device_put`` + the Pallas
        ``chunk_gather_train`` assembly against the consumer's train step.

        Yields ``GlobalBatch``es whose tokens/targets/loss_mask are device
        arrays. Abandoning the generator tears down stager and protocol
        worker deterministically — staged-but-unconsumed device buffers
        are released, not stranded.
        """
        from .device import DeviceStager  # deferred: pulls in jax + kernels

        if stager is None:
            stager = DeviceStager()
        def pack(*item):
            return self._pack(*item, row_pad=stager.row_pad, epoch=epoch)

        packs = self._pipelined(epoch, plan=plan, assemble=pack, track=False)
        for batch in stager.stream(packs):
            self._progress = (epoch, int(batch["step"]) + 1)
            yield batch

    def _pipelined(self, epoch: int, *, plan, assemble, track: bool = True):
        """The epoch_async machinery, parametrised over batch assembly."""
        q: queue.Queue = queue.Queue(maxsize=self.queue_depth)
        stop = object()
        abandoned = threading.Event()
        failure: list[BaseException] = []

        def put(item) -> bool:
            """Blocking put that aborts when the consumer is gone."""
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self._produce(epoch, plan=plan):
                    if not put(item):
                        return
            except BaseException as e:  # re-raised on the consumer side
                failure.append(e)
            finally:
                put(stop)

        t = threading.Thread(target=worker, daemon=True)
        self._worker = t
        self._async_epoch = True
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                batch = assemble(*item)
                if track:
                    self._progress = (epoch, int(batch["step"]) + 1)
                yield batch
        finally:
            abandoned.set()
            while True:  # drain so a blocked put() observes the signal fast
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join()
        if failure:
            # A failed protocol walk or storage read must not end the epoch
            # cleanly — the consumer would silently train on a short epoch.
            raise failure[0]

    # ------------------------------------------------------------ internals
    def _assemble(
        self,
        payloads,
        step: int,
        io_by_node: dict[int, StepIO],
        returned: "list[np.ndarray] | None" = None,
    ):
        """Decode raw record payloads and pack the fixed-shape grid."""
        with trace.span("loader.assemble", "decode", step=int(step)):
            flat = [decode_record(p) for p in payloads]
            tokens, mask = _to_grid(flat, self.seq_len + 1, self.pad_id)
        return GlobalBatch(
            tokens=tokens[:, :-1],
            targets=tokens[:, 1:],
            loss_mask=mask[:, 1:],
            step=step,
            io_by_node=io_by_node,
            # The redirected file ids behind each grid row, in row order —
            # lets equivalence/FT tests compare streams without re-decoding.
            returned=(
                np.concatenate(returned)
                if returned is not None else np.empty(0, dtype=np.int64)
            ),
        )

    def _pack(
        self,
        payloads,
        step: int,
        io_by_node: dict[int, StepIO],
        returned: "list[np.ndarray] | None" = None,
        *,
        row_pad: int = 8,
        epoch: int = -1,
    ):
        """Decode payloads into a HostPack for the device gather path,
        with the count of its loss-bearing tokens."""
        from .device import HostPack, pack_loss_tokens, pack_records

        with trace.span("loader.pack", "decode", step=int(step), epoch=epoch) as span:
            flat = [decode_record(p) for p in payloads]
            ret = (
                np.concatenate(returned)
                if returned is not None else np.empty(0, dtype=np.int64)
            )
            slot_tokens, lens, idx = pack_records(
                flat, ret if ret.size else None,
                seq_len=self.seq_len, pad_id=self.pad_id, row_pad=row_pad,
            )
            loss_tokens = pack_loss_tokens(lens, idx, self.seq_len)
            span.note(loss_tokens=loss_tokens)
        return HostPack(
            slot_tokens=slot_tokens, lens=lens, idx=idx,
            seq_len=self.seq_len, pad_id=self.pad_id,
            step=step, epoch=epoch, io_by_node=io_by_node, returned=ret,
            loss_tokens=loss_tokens,
        )

    def _produce(self, epoch: int, *, plan=None):
        """Yield (payloads, step, io, returned) per step — plan/execute split.

        Same plan-driven driver as ``Cluster.run_epoch``: under the
        ``"replay"`` engine the epoch is first computed in id-space
        (:class:`EpochPlanner`) — or a pre-computed ``plan`` is passed in by
        a :class:`repro.service.DataService`, which plans all of its
        sessions at once — the exact chunk-read schedule is handed to the
        storage backend, and the recorded events are replayed. The live
        engines (``"step"`` batched / ``"per_access"`` reference) walk the
        protocol directly with heuristic readahead.
        """
        cluster = self.cluster
        assert cluster.store is not None, (
            "RedoxLoader requires a Cluster built with a ChunkStore"
        )
        resume = self._resume
        if resume is not None and resume["epoch"] != epoch:
            # The restored cluster holds mid-epoch state for the suspended
            # epoch; walking any other epoch over it would trip the
            # begin_epoch drain assertions with a misleading message — and
            # silently dropping the saved suffix would violate exactly-once.
            raise RuntimeError(
                f"loader was resumed mid-epoch {resume['epoch']} (next step "
                f"{resume['start_step']}); consume that epoch to completion "
                f"before asking for epoch {epoch}"
            )
        self._progress = (epoch, resume["start_step"] if resume else 0)
        if self.engine == "replay":
            if plan is None:
                if resume is not None:
                    # Re-plan only the epoch *suffix* from the snapshot; the
                    # backend's readahead schedule is exactly the remaining
                    # chunk reads.
                    plan = EpochPlanner(cluster).plan_from(resume["snapshot"])
                else:
                    plan = EpochPlanner(cluster).plan(
                        self.sampler, epoch, self.batch_per_node,
                        stepping="floor_tail",
                    )
            self.last_plan = plan
            # Per-plan hit attribution is a delta over the (possibly shared)
            # backend's counters — exact for a lone loader, approximate when
            # service sessions run concurrently over one backend.
            b = cluster.backend_stats
            before = (b.scheduled_hits, b.prefetch_hits)
            stream = cluster.replay_stream(
                plan, epoch=epoch, batch_per_node=self.batch_per_node,
                stepping="floor_tail",
            )
        else:
            plan, before = None, None
            stream = cluster.epoch_stream(
                self.sampler if resume is None else None,
                epoch, self.batch_per_node,
                stepping="floor_tail", engine=self.engine, collect_payloads=True,
                resume=resume is not None,
                start_step=resume["start_step"] if resume else 0,
            )
        for step, returned, payloads, io_by_node in stream:
            yield payloads, step, io_by_node, returned
        if self._resume is resume:
            self._resume = None  # the resumed epoch completed
        if plan is not None:
            b = cluster.backend_stats
            plan.stats.scheduled_read_hits = b.scheduled_hits - before[0]
            plan.stats.heuristic_prefetch_hits = b.prefetch_hits - before[1]

    # ------------------------------------------------------ suspend/resume
    def suspend(self, out_dir: "str | Path", *, at: "tuple[int, int] | None" = None):
        """Checkpoint the data plane mid-epoch (DESIGN.md §10).

        Writes a :class:`~repro.core.elastic.ClusterSnapshot`
        (``data_state.npz`` + ``data_manifest.json``) plus a loader manifest
        under ``out_dir`` — the data-plane sibling of a model checkpoint. A
        fresh process resumes with :meth:`RedoxLoader.resume` and the batch
        stream continues byte-identically.

        ``at=(epoch, next_step)`` defaults to the loader's own consumption
        cursor. For the ``"replay"`` engine the snapshot is *derived* (a
        store-less shadow walks the epoch prefix in id-space), so training
        can keep consuming batches while suspend() runs — snapshot-without-
        stopping, the property the ``--resume-data`` launchers rely on. For
        the live engines the loader's protocol state IS the stream state:
        the current sync epoch stream is closed at its step boundary and the
        live cluster is captured (``epoch_async`` live walks run ahead of
        consumption and cannot be suspended exactly).
        """
        at = at or self._progress or self.resume_point
        if at is None:
            raise RuntimeError("suspend() before any epoch was started")
        epoch, next_step = int(at[0]), int(at[1])
        if self.engine == "replay":
            snap = EpochPlanner(self.cluster).state_at(
                self.sampler, epoch, self.batch_per_node, next_step,
                stepping="floor_tail",
            )
        else:
            if self._async_epoch:
                raise RuntimeError(
                    "live-engine epoch_async streams prefetch ahead of "
                    "consumption and cannot be suspended exactly; use the "
                    "replay engine (default) or the synchronous epoch()"
                )
            if (self._progress or self.resume_point) != (epoch, next_step):
                raise RuntimeError(
                    "a live engine can only suspend at its own cursor "
                    f"{self._progress or self.resume_point}, not {at!r}"
                )
            if self._live_stream is not None:
                self._live_stream.close()
                self._live_stream = None
            if self.cluster.sequences is None or self.cluster.epoch != epoch:
                # The epoch was never entered (e.g. a pump suspended before
                # reaching this session): materialise its step-0 state.
                assert next_step == 0, "mid-epoch cursor but no epoch state"
                self.cluster.begin_epoch(self.sampler, epoch)
                self.cluster._grid = (self.batch_per_node, "floor_tail")
            snap = self.cluster.snapshot(step=next_step)
        out_dir = Path(out_dir)
        snap.save(out_dir)
        (out_dir / LOADER_MANIFEST).write_text(json.dumps(dict(
            engine=self.engine,
            batch_per_node=self.batch_per_node,
            seq_len=self.seq_len,
            pad_id=self.pad_id,
            queue_depth=self.queue_depth,
            epoch=epoch,
            next_step=next_step,
            sampler=dict(
                num_files=self.sampler.num_files,
                num_nodes=self.sampler.num_nodes,
                seed=self.sampler.seed,
            ),
        )))
        return out_dir

    @classmethod
    def resume(cls, in_dir: "str | Path", store, **overrides) -> "RedoxLoader":
        """Rebuild a suspended loader from :meth:`suspend` files — typically
        in a fresh process holding only the (re-opened) ChunkStore.

        The next ``loader.epoch(epoch)`` / ``epoch_async(epoch)`` call for
        the suspended epoch continues from the saved step: the replay engine
        re-plans just the suffix (``EpochPlanner.plan_from``) and hands the
        remaining chunk schedule to the backend; live engines walk on from
        the restored protocol state. ``overrides`` replace loader-only knobs
        (``queue_depth``, ``seq_len``, ...), never protocol state.
        """
        in_dir = Path(in_dir)
        mf = json.loads((in_dir / LOADER_MANIFEST).read_text())
        snap = ClusterSnapshot.load(in_dir)
        cluster = Cluster.restore(snap, store=store)
        smp = mf["sampler"]
        sampler = EpochSampler(
            int(smp["num_files"]), int(smp["num_nodes"]), seed=smp["seed"]
        )
        kwargs = dict(
            batch_per_node=int(mf["batch_per_node"]),
            seq_len=int(mf["seq_len"]),
            pad_id=int(mf["pad_id"]),
            queue_depth=int(mf["queue_depth"]),
            engine=mf["engine"],
        )
        kwargs.update(overrides)
        loader = cls(cluster, sampler, **kwargs)
        loader._resume = {
            "epoch": int(mf["epoch"]),
            "start_step": int(mf["next_step"]),
            "snapshot": snap,
        }
        return loader

    @property
    def resume_point(self) -> "tuple[int, int] | None":
        """(epoch, next_step) a resumed loader will continue from, if any."""
        if self._resume is None:
            return None
        return self._resume["epoch"], self._resume["start_step"]
