"""Multi-job data service: one chunk store + shared residency, N training jobs.

Every layer below this one is single-job: a :class:`Cluster` owns its
abstract memory, RNG stream, and epoch state. :class:`DataService` stacks N
of those (one per job — each job keeps its *own* protocol state, sampler and
seed, so its returned stream is exactly what it would be served solo) on top
of ONE physical layer: a single :class:`ChunkStore` fronted by a
:class:`SharedResidency` cache. Redirection is what makes the sharing cheap:
jobs never coordinate *which file* a slot returns, only *which chunk bytes*
back the slot — and those bytes are identical across jobs.

Execution modes:

* ``engine="replay"`` (default): :meth:`DataService.plan_epoch` runs the
  clairvoyant :class:`EpochPlanner` per session, installs exact per-chunk
  claim refcounts on the residency, merges every session's chunk-read
  schedule (``merge_read_schedules``) and hands the deduplicated physical
  order (``first_read_order``) to ``ChunkStore.schedule_reads`` — backend
  readahead stays clairvoyant across *all* jobs at once.
* ``engine="step" | "per_access"``: live walks; the residency retains chunks
  by exact liveness instead of planned refcounts.

**Co-refill** (``co_refill=True``): a pluggable refill-choice hook
(:attr:`LocalNode.refill_filter`) narrows the protocol's uniform tie-break
toward chunks that are already shared-cache resident (free bytes), else
toward chunks another session still needs (the read it forces becomes a
future shared hit). The preference is driven only by *other* jobs'
independent permutations, so each job's returned stream remains a uniform
shuffle (DESIGN.md §9; ``tests/test_randomness_property.py``). Off by
default — with it off, every session's stream is byte-identical to its solo
run, which is what the fault-tolerance tests pin down.

:meth:`DataService.co_epoch` is the shared serving loop: a round-robin pump
that advances every session one step per round (lockstep keeps claim order
equal to the merged plan order) and yields ``(job_id, GlobalBatch)``.
Sessions can instead be consumed independently — ``JobSession.epoch`` /
``epoch_async`` are the familiar loader API — and still share bytes through
the residency.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np

from repro_torch.obs import tracer as trace

from ..core.loader import RedoxLoader
from ..core.planner import EpochPlan, EpochPlanner, PlanRecorder
from ..core.spec import SessionSpec
from ..core.stats import ServiceStats
from ..core.storage import first_read_order, merge_read_schedules
from .residency import SharedResidency, session_still_needs

__all__ = [
    "AdmissionControl",
    "AdmissionRejected",
    "DataService",
    "JobSession",
]

SERVICE_MANIFEST = "service_manifest.json"


class AdmissionRejected(RuntimeError):
    """``open_session`` refused: admitting the job would push the service's
    predicted aggregate read rate past the storage budget (DESIGN.md §14).
    Relayed typed over the transport wire, so a remote trainer catches
    exactly this class."""


@dataclasses.dataclass(frozen=True)
class AdmissionControl:
    """Storage-bandwidth admission policy for :meth:`DataService.open_session`.

    Redox reads every file exactly once per epoch, so a session's steady
    demand is a pure function of known quantities: the dataset's chunk
    bytes spread over its ``steps_per_epoch`` training steps, one step per
    ``compute_per_step_s`` (the job's measured or modelled step time —
    ``repro.autotune.calibrate`` measures both this and the bandwidth). A
    session is admitted iff

        Σ_admitted epoch_bytes / (steps * compute_per_step_s)  ≤  bandwidth

    The estimate deliberately ignores shared-cache hits — overlap between
    jobs only *lowers* the physical rate, so this is a safe upper bound.

    ``mode="reject"`` raises :class:`AdmissionRejected` immediately;
    ``mode="queue"`` blocks up to ``queue_timeout_s`` for capacity to free
    (sessions closing), then raises the same typed error.
    """

    bandwidth_bytes_per_s: float
    compute_per_step_s: float
    mode: str = "reject"            # "reject" | "queue"
    queue_timeout_s: float = 30.0

    def __post_init__(self):
        if self.mode not in ("reject", "queue"):
            raise ValueError(
                f"unknown admission mode {self.mode!r}; "
                "expected 'reject' or 'queue'"
            )


class _SessionStore:
    """Per-session facade over the shared store: reads go through the
    residency under the session's job id; the merged-schedule install is
    service-owned, so the per-plan ``schedule_reads`` becomes a no-op."""

    def __init__(self, service: "DataService", job_id):
        self._service = service
        self._job = job_id
        self._real = service.store
        #: Per-session progressive fidelity (DESIGN.md §15): set by
        #: ``RedoxLoader.from_spec`` when the session's spec asks for
        #: truncated bands; claims decode at this fidelity without
        #: affecting other sessions sharing the store.
        self.default_fidelity: "int | None" = None

    @property
    def plan(self):
        return self._real.plan

    @property
    def spec(self):
        """The shared store's StoreSpec (None for spec-less store doubles)."""
        return getattr(self._real, "spec", None)

    @property
    def backend_stats(self):
        return self._real.backend_stats

    @property
    def wants_prefetch(self) -> bool:
        return self._real.wants_prefetch

    @property
    def has_schedule(self) -> bool:
        return self._real.has_schedule

    def prefetch_chunks(self, chunks) -> None:
        self._real.prefetch_chunks(chunks)

    def read_chunk(self, chunk: int):
        return self._service._read_chunk(
            self._job, chunk, fidelity=self.default_fidelity
        )

    def read_file(self, file_id: int):
        return self._real.read_file(file_id)

    def schedule_reads(self, chunks) -> None:
        pass  # the service installs ONE merged schedule on the real store

    def close(self) -> None:
        pass  # the service (or its creator) owns the real store


class JobSession:
    """One job's view of the service: a thin single-job loader session."""

    def __init__(self, service: "DataService", job_id, cluster, sampler, loader):
        self.service = service
        self.job_id = job_id
        self.cluster = cluster
        self.sampler = sampler
        self.loader = loader
        self.closed = False

    @property
    def engine(self) -> str:
        return self.loader.engine

    @property
    def spec(self) -> SessionSpec:
        """The SessionSpec describing this session's loader stack."""
        return self.loader.spec

    @property
    def last_plan(self):
        return self.loader.last_plan

    @property
    def stats(self) -> ServiceStats:
        """This job's shared-residency counters."""
        return self.service.residency.job_stats(self.job_id)

    def steps_per_epoch(self, epoch: int = 0) -> int:
        return self.loader.steps_per_epoch(epoch)

    def epoch(self, epoch: int):
        """Yield this job's GlobalBatches. The service plans its epoch on
        first touch, so independently consumed sessions still share bytes."""
        for item in self._produce_guarded(epoch):
            yield self.loader._assemble(*item)

    def epoch_async(self, epoch: int):
        """Double-buffered variant — safe to consume from a per-job thread;
        the shared residency and the service planner are lock-protected.
        For live (``step``/``per_access``) sessions under concurrent
        threads, the liveness probe reads other sessions' evolving cluster
        state unsynchronised: streams stay exact, but retention becomes
        approximate (a stale read may cost a redundant re-read or hold a
        chunk longer). Replay sessions (the default) use claim refcounts
        and are exact under concurrency."""
        plan = self._begin_epoch(epoch)
        try:
            yield from self.loader.epoch_async(epoch, plan=plan)
        finally:
            self._end_epoch(epoch)

    def _produce_guarded(self, epoch: int):
        """The session's raw step stream with claim bookkeeping around it
        (shared by :meth:`epoch` and the service pump)."""
        plan = self._begin_epoch(epoch)
        try:
            for item in self.loader._produce(epoch, plan=plan):
                # Keep the loader's suspend cursor exact for pump-driven
                # sessions: the step in hand is consumed the moment this
                # generator returns from next().
                self.loader._progress = (epoch, int(item[1]) + 1)
                yield item
        finally:
            self._end_epoch(epoch)

    def _begin_epoch(self, epoch: int):
        """Resolve this epoch's plan and (re)install the job's exact claim
        pool — full-epoch totals even when a previous run of the same epoch
        was abandoned with the pool partially drained."""
        svc = self.service
        plan = svc._plan_for(self, epoch)
        with svc._lock:
            svc._active_epoch[self.job_id] = epoch
            if plan is not None:
                svc.residency.begin_epoch_claims(
                    self.job_id, epoch, Counter(plan.load_chunk.tolist())
                )
        return plan

    def _end_epoch(self, epoch: int) -> None:
        """Retire this job's claim pool for ``epoch``: a completed epoch
        drained it to zero (removing the key lets a re-run's plan-time
        install register fresh full counts); an abandoned one left it
        under-counting the remaining reads, so unwinding it keeps other
        sessions' residency exact."""
        svc = self.service
        svc._active_epoch.pop(self.job_id, None)
        svc.residency.drop_claims(self.job_id, epoch)

    def close(self) -> None:
        self.service.close_session(self.job_id)


class DataService:
    """One shared chunk cache serving many concurrent training jobs."""

    def __init__(
        self,
        store,
        *,
        cache_limit_bytes: "int | None" = None,
        co_refill: bool = False,
        eviction: str = "belady",
        admission: "AdmissionControl | None" = None,
    ):
        self.store = store
        self.plan = store.plan
        self.co_refill = co_refill
        self.admission = admission
        self.residency = SharedResidency(
            store, cache_limit_bytes=cache_limit_bytes, eviction=eviction
        )
        self.residency.set_liveness(self._live_sessions_need)
        # Serialises planning and claim (un)installs: sessions consumed from
        # concurrent threads must not interleave plan_epoch runs.
        self._lock = threading.RLock()
        self._sessions: "dict[object, JobSession]" = {}
        # Plans are cached per epoch (pure functions of (session, epoch), so
        # re-runs reuse them); only the newest few epochs are kept.
        self._epoch_plans: "dict[int, dict[object, EpochPlan]]" = {}
        self._active_epoch: "dict[object, int]" = {}
        # Admission bookkeeping: predicted bytes/s per admitted job, and a
        # condition close_session notifies so queued opens can re-check.
        self._admitted_rates: "dict[object, float]" = {}
        self._admission_cv = threading.Condition()
        self.last_plan_time_s = 0.0

    # ------------------------------------------------------------- sessions
    def open_session(
        self,
        job_id,
        spec: "SessionSpec | None" = None,
        *,
        resume_from: "str | Path | None" = None,
        **kwargs,
    ) -> JobSession:
        """Open a job session with its own protocol state and RNG stream.

        ``spec`` is the :class:`~repro.core.spec.SessionSpec` describing the
        session — the same object a standalone
        ``RedoxLoader.from_spec(spec, store)`` accepts and the transport
        wire protocol carries; a single-session service run is
        byte-identical to that solo run (``tests/test_service.py``).

        The legacy keyword spelling (``policy=``, ``seed=``,
        ``batch_per_node=``, ... plus the ``use_planner`` alias) is kept as
        a deprecation shim: keywords are folded into a SessionSpec via
        :meth:`SessionSpec.from_kwargs`.

        ``resume_from`` re-opens a session suspended by
        :meth:`DataService.suspend`: the cluster is restored from the saved
        snapshot (every protocol argument is taken from the files, not from
        ``spec``) and the session's next epoch continues at the saved step.
        """
        if spec is None:
            spec = SessionSpec.from_kwargs(**kwargs)  # deprecation shim
        elif kwargs:
            raise TypeError(
                "pass either a SessionSpec or the legacy keyword form, not "
                f"both (got spec and {sorted(kwargs)})"
            )
        with self._lock:
            if job_id in self._sessions:
                raise ValueError(f"job {job_id!r} already has an open session")
        if resume_from is not None:
            # Same restore path as a standalone loader — only the store
            # differs (reads route through the shared residency).
            loader = RedoxLoader.resume(resume_from, _SessionStore(self, job_id))
        else:
            loader = RedoxLoader.from_spec(spec, _SessionStore(self, job_id))
        if self.admission is not None:
            self._admit(job_id, loader)  # raises AdmissionRejected
        session = JobSession(
            self, job_id, loader.cluster, loader.sampler, loader
        )
        if self.co_refill:
            self._install_refill_filter(session)
        with self._lock:
            if job_id in self._sessions:
                raise ValueError(f"job {job_id!r} already has an open session")
            # Copy-on-write: the residency's liveness callback iterates the
            # session map from reader threads WITHOUT the service lock
            # (taking it there would invert the residency/service lock
            # order) — so mutations swap in a fresh dict instead.
            self._sessions = {**self._sessions, job_id: session}
        self.residency.job_stats(job_id)  # materialise the per-job counters
        return session

    # ------------------------------------------------------------ admission
    def _session_rate(self, loader) -> float:
        """Predicted steady read demand of one session, bytes/s: the dataset
        read exactly once per epoch (the Redox invariant), spread over the
        session's steps at the admission policy's per-step compute time."""
        steps = loader.steps_per_epoch(0)
        if steps <= 0:
            return 0.0
        epoch_bytes = float(np.asarray(self.plan.chunk_bytes).sum())
        return epoch_bytes / (steps * self.admission.compute_per_step_s)

    def _admit(self, job_id, loader) -> None:
        adm = self.admission
        rate = self._session_rate(loader)
        deadline = time.monotonic() + adm.queue_timeout_s
        with self._admission_cv:
            while True:
                admitted = sum(self._admitted_rates.values())
                if admitted + rate <= adm.bandwidth_bytes_per_s:
                    self._admitted_rates[job_id] = rate
                    trace.instant(
                        "service.admit", "service", job=str(job_id),
                        rate=rate, admitted=admitted + rate,
                    )
                    return
                detail = (
                    f"job {job_id!r} needs {rate / 1e6:.1f} MB/s; "
                    f"{admitted / 1e6:.1f} MB/s of the "
                    f"{adm.bandwidth_bytes_per_s / 1e6:.1f} MB/s storage "
                    f"budget is already committed to "
                    f"{len(self._admitted_rates)} job(s)"
                )
                remaining = deadline - time.monotonic()
                if adm.mode == "reject" or remaining <= 0:
                    trace.instant(
                        "service.admission_rejected", "service",
                        job=str(job_id), rate=rate, admitted=admitted,
                    )
                    queued = "" if adm.mode == "reject" else (
                        f" (queued {adm.queue_timeout_s:.0f}s without "
                        f"capacity freeing)"
                    )
                    raise AdmissionRejected(detail + queued)
                self._admission_cv.wait(timeout=min(remaining, 0.5))

    def admission_report(self) -> "dict | None":
        """The admission plane's live view (None when admission is off)."""
        if self.admission is None:
            return None
        with self._admission_cv:
            rates = dict(self._admitted_rates)
        return {
            "bandwidth_bytes_per_s": self.admission.bandwidth_bytes_per_s,
            "compute_per_step_s": self.admission.compute_per_step_s,
            "mode": self.admission.mode,
            "admitted_bytes_per_s": sum(rates.values()),
            "per_job_bytes_per_s": {str(j): r for j, r in rates.items()},
        }

    def close_session(self, job_id) -> None:
        """Close a session (mid-epoch kills included): its outstanding claim
        refcounts are unwound so other jobs' residency is unaffected, and
        the job id becomes reusable (a restarted job reopens under the same
        id with fresh protocol state; its ServiceStats keep accumulating)."""
        with self._lock:
            session = self._sessions.get(job_id)
            if session is None or session.closed:
                return
            remaining = dict(self._sessions)
            del remaining[job_id]
            self._sessions = remaining  # copy-on-write, see open_session
            session.closed = True
            self._active_epoch.pop(job_id, None)
            for plans in self._epoch_plans.values():
                plans.pop(job_id, None)
            self.residency.drop_claims(job_id)
        with self._admission_cv:
            if self._admitted_rates.pop(job_id, None) is not None:
                self._admission_cv.notify_all()  # wake queued open_sessions

    @property
    def sessions(self) -> "list[JobSession]":
        return [s for s in self._sessions.values() if not s.closed]

    def session(self, job_id) -> JobSession:
        try:
            return self._sessions[job_id]
        except KeyError:
            raise KeyError(
                f"no open session for job {job_id!r} (open sessions: "
                f"{sorted(map(repr, self._sessions)) or 'none'}); "
                "open_session() it first — a closed job's id is reusable"
            ) from None

    def close(self) -> None:
        """Close every session. Idempotent: a second close() (or a close()
        racing individual close_session calls) is a no-op."""
        for job_id in list(self._sessions):
            self.close_session(job_id)
        self.residency.end_epoch()

    # ------------------------------------------------------ suspend/resume
    def suspend(self, out_dir: "str | Path") -> Path:
        """Atomically checkpoint every open session's data-plane state.

        Call with no stream mid-flight (the pump abandoned or between
        epochs): each session writes its loader suspend files
        (``RedoxLoader.suspend`` — a derived shadow snapshot for replay
        sessions, the live cluster state otherwise) under one directory,
        plus a service manifest. Shared-residency claims are *not*
        serialized — they are a pure function of the per-session plans and
        cursors, and :meth:`resume`'s plan_epoch reinstalls exactly the
        remaining claim counts.
        """
        with self._lock:
            assert not self._active_epoch, (
                "suspend() with a session stream mid-flight; abandon the "
                "pump (or finish the epoch) first"
            )
            sessions = self.sessions
        if self.co_refill and any(s.engine == "replay" for s in sessions):
            # A replay session's snapshot is derived on a filter-less solo
            # shadow (EpochPlanner.state_at); under co-refill the executed
            # prefix followed the jointly-planned tie-breaks instead, so the
            # derived state would not match what was actually consumed —
            # refuse rather than resume a diverging stream. Live-engine
            # co-refill sessions snapshot their real state and are fine.
            raise NotImplementedError(
                "suspend() of a co_refill service with replay sessions is "
                "not supported: their snapshots are derived by solo shadow "
                "simulation, which diverges from the jointly-planned "
                "co-refill prefix; use co_refill=False or live engines"
            )
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        jobs = []
        for i, s in enumerate(sessions):
            sub = f"session_{i:03d}"
            s.loader.suspend(out_dir / sub)
            jobs.append({"job_id": s.job_id, "dir": sub})
        (out_dir / SERVICE_MANIFEST).write_text(json.dumps(dict(
            co_refill=self.co_refill,
            cache_limit_bytes=self.residency.cache_limit_bytes,
            jobs=jobs,
        )))
        return out_dir

    @classmethod
    def resume(cls, in_dir: "str | Path", store, **overrides) -> "DataService":
        """Rebuild a suspended service — sessions, protocol state, and the
        exact remaining residency claims — from :meth:`suspend` files in a
        fresh process holding only the re-opened ChunkStore."""
        in_dir = Path(in_dir)
        mf = json.loads((in_dir / SERVICE_MANIFEST).read_text())
        svc = cls(
            store,
            cache_limit_bytes=overrides.pop(
                "cache_limit_bytes", mf.get("cache_limit_bytes")
            ),
            co_refill=overrides.pop("co_refill", mf.get("co_refill", False)),
        )
        for job in mf["jobs"]:
            svc.open_session(job["job_id"], resume_from=in_dir / job["dir"])
        return svc

    # ------------------------------------------------------------- planning
    _PLAN_EPOCHS_KEPT = 4  # newest epochs whose plans/claims stay cached

    def plan_epoch(self, epoch: int) -> "dict[object, EpochPlan]":
        """Plan every replay session's epoch and fuse the I/O schedules.

        Runs :class:`EpochPlanner` per session (jointly, on interleaved
        shadow clusters, when co-refill is on — the hook's preferences are
        themselves part of the plan), installs each session's exact claim
        refcounts on the residency (keyed per (job, epoch) — jobs running
        different epochs concurrently never disturb each other), and hands
        the merged deduplicated physical read order to the storage backend.
        Plans are cached; re-planning an epoch only fills sessions that do
        not have a plan yet (e.g. opened later). Live-engine sessions are
        skipped: their reads are not knowable up front and use liveness
        retention instead.
        """
        t0 = time.perf_counter()
        with self._lock:
            sessions = [s for s in self.sessions if s.engine == "replay"]
            if not sessions:
                return {}
            plans = self._epoch_plans.setdefault(epoch, {})
            missing = [s for s in sessions if s.job_id not in plans]
            if missing:
                # Sessions resumed mid-epoch get *suffix* plans cut from
                # their snapshots — their claim counts are exactly the
                # remaining reads, so the shared residency stays exact
                # across a suspend/resume of the whole service.
                resumed = {
                    s.job_id: s.loader._resume
                    for s in missing
                    if s.loader._resume is not None
                    and s.loader._resume["epoch"] == epoch
                }
                if self.co_refill and len(missing) > 1 and not resumed:
                    fresh = self._joint_plan(missing, epoch)
                else:
                    fresh = {}
                    for s in missing:
                        rp = resumed.get(s.job_id)
                        if rp is not None:
                            fresh[s.job_id] = EpochPlanner(s.cluster).plan_from(
                                rp["snapshot"]
                            )
                        else:
                            fresh[s.job_id] = EpochPlanner(s.cluster).plan(
                                s.sampler, epoch, s.loader.batch_per_node,
                                stepping="floor_tail",
                            )
                plans.update(fresh)
            claims = merge_read_schedules(
                [_per_step_chunks(plans[s.job_id]) for s in sessions
                 if s.job_id in plans]
            )
            # The same merged order, duplicates included, is the Belady
            # next-use index: the residency drains it claim by claim and
            # always knows each resident chunk's next planned use.
            self.residency.install_schedule(epoch, claims)
            for s in sessions:
                if s.job_id in plans:
                    self.residency.install_claims(
                        s.job_id, epoch,
                        Counter(plans[s.job_id].load_chunk.tolist()),
                    )
            # Installing a schedule REPLACES the backend's current one
            # (discarding its in-flight readahead), so only do it while no
            # session is mid-stream — a late planner (job opened/advancing
            # while others run) must not clobber their exact readahead.
            if not self._active_epoch:
                self.store.schedule_reads(first_read_order(claims))
            self._prune_plans_locked()
            self.last_plan_time_s = time.perf_counter() - t0
            return dict(plans)

    def _prune_plans_locked(self) -> None:
        while len(self._epoch_plans) > self._PLAN_EPOCHS_KEPT:
            oldest = min(self._epoch_plans)
            for job_id in self._epoch_plans.pop(oldest):
                # never-started pools of the pruned epoch must not pin bytes
                if self._active_epoch.get(job_id) != oldest:
                    self.residency.drop_claims(job_id, oldest)

    def _plan_for(self, session: JobSession, epoch: int):
        """The session's plan for ``epoch``, planning the service's epoch on
        first touch — independently consumed sessions (``JobSession.epoch``)
        share bytes without the caller invoking :meth:`plan_epoch` by hand."""
        if session.engine != "replay":
            return None
        with self._lock:
            plan = self._epoch_plans.get(epoch, {}).get(session.job_id)
            if plan is None:
                plan = self.plan_epoch(epoch).get(session.job_id)
            return plan

    def _read_chunk(self, job_id, chunk: int, fidelity: "int | None" = None):
        """Session-store read path: claims land in the pool of the epoch the
        job is currently consuming."""
        return self.residency.read_chunk(
            job_id, chunk,
            epoch=self._active_epoch.get(job_id), fidelity=fidelity,
        )

    def _joint_plan(self, sessions, epoch):
        """Interleaved co-refill planning: every session's shadow cluster is
        advanced one step per round (the pump's lockstep), with refill hooks
        consulting a simulated shared cache and the other shadows' exact
        liveness — so the plans already contain the co-refill decisions."""
        shadows = [s.cluster.planning_clone() for s in sessions]
        sim_cached: "set[int]" = set()

        def shadow_needs(i: int, chunk: int) -> bool:
            return session_still_needs(shadows[i], chunk)

        def on_load(chunk: int) -> None:
            # Retention re-check mirrors SharedResidency: cached while any
            # shadow (including the loader, pre-release) still needs it.
            if any(shadow_needs(i, chunk) for i in range(len(shadows))):
                sim_cached.add(chunk)
            else:
                sim_cached.discard(chunk)

        def make_filter(me: int):
            def filt(group, chunk_ids):
                return self._preferred_chunks(
                    chunk_ids,
                    cached=lambda k: k in sim_cached,
                    wanted=lambda k: any(
                        shadow_needs(i, k) for i in range(len(shadows)) if i != me
                    ),
                    job=sessions[me].job_id,
                )
            return filt

        recs = []
        for i, shadow in enumerate(shadows):
            rec = _JointRecorder(on_load)
            recs.append(rec)
            for node in shadow.nodes:
                node.refill_filter = make_filter(i)
        gens = [
            shadow.epoch_stream(
                s.sampler, epoch, s.loader.batch_per_node,
                stepping="floor_tail", recorder=recs[i],
            )
            for i, (s, shadow) in enumerate(zip(sessions, shadows))
        ]
        steps = [0] * len(sessions)
        done = [False] * len(sessions)
        while not all(done):
            for i, gen in enumerate(gens):
                if done[i]:
                    continue
                try:
                    step, _, _, _ = next(gen)
                    steps[i] = step + 1
                except StopIteration:
                    done[i] = True
        plans = {}
        for i, s in enumerate(sessions):
            plan = EpochPlan.from_recorder(
                recs[i],
                epoch=epoch,
                batch_per_node=s.loader.batch_per_node,
                num_nodes=shadows[i].num_nodes,
                stepping="floor_tail",
                num_steps=steps[i],
                node_stats=[n.stats for n in shadows[i].nodes],
            )
            plans[s.job_id] = plan
        return plans

    # ------------------------------------------------------------ co-refill
    def _install_refill_filter(self, session: JobSession) -> None:
        def filt(group, chunk_ids, _job=session.job_id):
            return self._preferred_chunks(
                chunk_ids,
                cached=self.residency.is_cached,
                wanted=lambda k: any(
                    session_still_needs(s.cluster, k)
                    for s in self.sessions
                    if s.job_id != _job and s.engine != "replay"
                ),
                job=_job,
            )
        for node in session.cluster.nodes:
            node.refill_filter = filt

    def _preferred_chunks(self, chunk_ids, *, cached, wanted, job):
        """Co-refill preference over the protocol's tie-break pool.

        Only chunks some OTHER session still needs are ever preferred — the
        preference is a function of the other jobs' (independent) states,
        never of the choosing job's own history, which is what keeps each
        job's stream a uniform shuffle (DESIGN.md §9) and makes a solo
        session's co-refill a no-op (byte-identical to its solo run).
        Among the other-needed candidates, ones whose bytes are already
        shared-cache resident come first (consume before produce).
        """
        ids = [int(k) for k in np.asarray(chunk_ids).tolist()]
        shareable = [k for k in ids if wanted(k)]
        chosen = [k for k in shareable if cached(k)] or shareable
        if not chosen or len(chosen) == len(ids):
            return None  # no narrowing: tie-break stays untouched
        self.residency.job_stats(job).co_refill_hits += 1
        return np.asarray(chosen, dtype=np.int64)

    def _live_sessions_need(self, chunk: int) -> bool:
        """Residency liveness: some live-engine session still needs ``chunk``.
        Replay sessions are excluded — their cluster state does not evolve
        during replay; planned claim refcounts cover them exactly."""
        return any(
            session_still_needs(s.cluster, chunk)
            for s in self.sessions
            if s.engine != "replay"
        )

    # -------------------------------------------------------------- serving
    def co_epoch(
        self,
        epoch: int,
        *,
        ready=None,
        admit=None,
        idle=None,
        on_done=None,
        raw: bool = False,
    ):
        """THE shared serving loop: round-robin pump over all open sessions.

        Yields ``(job_id, GlobalBatch)``; each session advances one training
        step per round, so co-scheduled jobs stay in lockstep and the claim
        order matches the merged plan order (maximal schedule hits).
        Sessions closed mid-epoch (``close_session``) are detached at the
        next round; the survivors' streams are unaffected.

        Rounds are cursor-aware: a pump abandoned mid-round (suspend) left
        some sessions one step ahead, so the resumed pump serves the lagging
        sessions first — the combined (job, step) stream continues exactly
        where the suspended one stopped.

        The transport server hooks (all default-off; in-process behaviour is
        unchanged without them):

        * ``ready(session) -> bool`` — per-session backpressure: a session
          that is not ready (its shared-memory ring is full) is *skipped*
          this round instead of served; its cursor does not advance, so
          lockstep degrades gracefully and snaps back once it drains.
          Per-job streams stay exact under skipping — sharing rides the
          planned claim refcounts, not the serving order (only backend
          schedule hit-rate can degrade). Pass ``idle`` too: a round where
          no session is ready calls ``idle()`` (sleep / abort check)
          instead of busy-spinning.
        * ``admit() -> iterable[JobSession]`` — dynamic membership: called
          each round; returned sessions not yet in the pump join it
          mid-epoch (planned on entry, claims installed, cursor-aware for
          resumed sessions). When ``admit`` is given the pump STARTS EMPTY
          and ends once every admitted session finished and ``admit``
          returns nothing new.
        * ``on_done(session)`` — fires when a session's epoch completes
          (the server writes its end-of-epoch sentinel there).
        * ``raw=True`` — yield ``(session, (payloads, step, io, returned))``
          instead of assembled batches (the server encodes frames straight
          from the raw step, so token bytes are copied once into the ring).
        """
        gens, cursors = {}, {}
        live: "list[JobSession]" = []

        def _attach(s):
            gens[s.job_id] = s._produce_guarded(epoch)
            cursors[s.job_id] = (
                s.loader._resume["start_step"]
                if s.loader._resume is not None
                and s.loader._resume["epoch"] == epoch
                else 0
            )
            # Pin every loader's suspend cursor up front: a pump abandoned
            # before reaching some session must still be able to suspend it
            # (at the point it would have continued from).
            s.loader._progress = (epoch, cursors[s.job_id])
            live.append(s)

        def _admit():
            fresh = [
                s for s in admit()
                if s.job_id not in gens and not s.closed
            ]
            if any(s.engine == "replay" for s in fresh):
                # plan_epoch only fills sessions without a cached plan, so
                # late joiners plan without disturbing running sessions.
                self.plan_epoch(epoch)
            for s in fresh:
                _attach(s)

        if admit is None:
            sessions = self.sessions
            if any(s.engine == "replay" for s in sessions):
                self.plan_epoch(epoch)  # cached plans reused; claims reinstalled
            for s in sessions:
                _attach(s)
        try:
            while True:
                if admit is not None:
                    _admit()
                for s in list(live):  # detach sessions closed between rounds
                    if s.closed:
                        live.remove(s)
                        gens[s.job_id].close()
                if not live:
                    break
                candidates = (
                    live if ready is None else [s for s in live if ready(s)]
                )
                if not candidates:
                    if idle is not None:
                        idle()
                    continue
                round_ = min(cursors[s.job_id] for s in candidates)
                for s in list(live):
                    if s.closed:
                        live.remove(s)
                        gens[s.job_id].close()
                        continue
                    if s not in candidates or cursors[s.job_id] != round_:
                        continue
                    try:
                        with trace.span(
                            "service.pump", "service",
                            job=str(s.job_id), round=round_,
                        ):
                            item = next(gens[s.job_id])
                    except StopIteration:
                        live.remove(s)
                        if on_done is not None:
                            on_done(s)
                        continue
                    cursors[s.job_id] = int(item[1]) + 1
                    if raw:
                        yield s, item
                    else:
                        yield s.job_id, s.loader._assemble(*item)
        finally:
            for s in live:  # consumer abandoned the pump mid-epoch
                gens[s.job_id].close()
                # close() on a never-started generator does not run its
                # body, so _end_epoch never fires for sessions the pump
                # had not reached — retire their plan-time claims here
                # (a no-op for sessions whose generator did clean up).
                self.residency.drop_claims(s.job_id, epoch)
            self.residency.end_epoch()

    # ---------------------------------------------------------------- stats
    def aggregate_stats(self) -> ServiceStats:
        """Whole-service counters. Evictions and cache bypasses are
        attributed to the claiming job at the point of decision (the insert
        that forced them), so the per-job merge sums to the service totals —
        no global overwrite, no K-fold double count when a consumer sums the
        per-job reports. ``peak_cache_bytes`` is the one genuinely
        service-global quantity (cache residency is shared), so it comes
        from the residency, not from max-ing per-job copies (which are 0)."""
        out = ServiceStats()
        for st in self.residency.per_job_stats.values():
            out = out.merge(st)
        out.peak_cache_bytes = self.residency.peak_cache_bytes
        return out

    def stats_report(self) -> dict:
        """Per-job and aggregate counters (the BENCH/CLI-facing view).

        ``per_job`` holds only what each job caused (its evictions are the
        ones *its* inserts forced); cache-wide state lives in the distinct
        ``service`` record, so summing per-job rows never double-counts
        cache pressure.
        """
        per_job = self.residency.per_job_stats
        agg = self.aggregate_stats()
        res = self.residency
        report = {
            "per_job": {str(j): st.to_dict() for j, st in per_job.items()},
            "bytes_per_job": {
                str(j): st.physical_bytes + st.shared_bytes
                for j, st in per_job.items()
            },
            # dup_loads_avoided is a derived @property, so it rides on top
            # of the round-trippable field dict.
            "aggregate": {
                **agg.to_dict(), "dup_loads_avoided": agg.dup_loads_avoided,
            },
            "service": {
                "eviction": res.eviction,
                "evictions": res.evictions,
                "cache_bypass": res.cache_bypass,
                "cache_bytes": res.cache_bytes,
                "peak_cache_bytes": res.peak_cache_bytes,
                "cache_limit_bytes": res.cache_limit_bytes,
            },
        }
        admission = self.admission_report()
        if admission is not None:
            report["admission"] = admission
        return report


class _JointRecorder(PlanRecorder):
    """PlanRecorder that also reports each load to the joint-planning sim."""

    def __init__(self, on_load_cb):
        super().__init__()
        self._cb = on_load_cb

    def on_load(self, owner, chunk, fill_rate, files):
        super().on_load(owner, chunk, fill_rate, files)
        self._cb(int(chunk))


def _per_step_chunks(plan: EpochPlan) -> "list[list[int]]":
    """Plan loads bucketed by step (tail pseudo-step included)."""
    depth = plan.num_steps + (1 if plan.has_tail else 0)
    return [
        plan.load_chunk[slice(*plan.load_range(step))].tolist()
        for step in range(depth)
    ]
