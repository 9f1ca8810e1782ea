"""Shared chunk residency: one refcounted byte cache serving many jobs.

The paper's one-time chunk layout is explicitly multi-job ("the pre-organized
data chunks can be re-used to train different models"), and FanStore
(PAPERS.md) shows that a shared, deduplicated cache across trainers is where
the large-scale I/O wins are. :class:`SharedResidency` is that cache for a
:class:`repro.service.DataService`: every session's ``read_chunk`` claims go
through it, and a chunk's bytes are read from storage exactly once per
*residency interval* — from its first claim to its last — no matter how many
jobs consume it.

Two release disciplines, matching the service's two execution modes:

* **Planned refcounts** (replay sessions): ``install_claims`` registers each
  job's exact per-chunk claim counts (from its :class:`EpochPlan`). A chunk
  is released the moment its last planned claim is served — Belady-exact,
  because the plans *are* the future.
* **Liveness** (live ``step``/``per_access`` sessions): a chunk is retained
  while any live session still *needs* it — session ``s`` will load chunk
  ``k`` again iff some file of ``k`` is neither consumed nor resident at
  ``k``'s owner node (a file can only enter memory through its own chunk's
  load). The probe runs at claim time, *before* the claiming session merges
  the chunk into its abstract memory, so live-mode retention is a
  conservative over-approximation: within an epoch it can grow toward the
  dataset size (released at the end-of-epoch sweep) — bound it with
  ``cache_limit_bytes`` when that matters. Replay sessions (the default
  engine) use the exact planned refcounts instead.

**Byte cap + clairvoyant eviction.** An optional ``cache_limit_bytes``
bounds residency. When the cap bites, the default ``eviction="belady"``
policy runs Belady/MIN against the *next-use index*: the service installs
the merged multi-job claim schedule (:meth:`install_schedule` — the same
``merge_read_schedules`` order that drives backend readahead), positions
drain as claims are served, and the evicted entry is the one whose next
planned claim is farthest in the future. Entries with *no* planned next use
(live-mode liveness retention, or drained/unwound plans) are farthest of
all and are evicted first, least-recently-claimed among themselves — so a
live-only service degrades exactly to LRU, and ``eviction="lru"`` forces
that behaviour everywhere (the differential baseline for
``benchmarks/eviction.py``). On a compressed store (DESIGN.md §15) the
cache holds *compressed frames* and each claim decodes its own copy, so
``cache_limit_bytes`` counts compressed bytes — the codec's compression
ratio directly multiplies how many chunks fit under the same cap.
Belady also gates *admission*: an incoming
chunk whose own next use is farther than every resident's is not cached at
all (evicting a sooner-needed chunk for it could only lose). Evicted
claims fall back to physical re-reads (``ServiceStats.evictions``,
attributed to the claiming job); refused inserts are counted as
``ServiceStats.cache_bypass`` — never silently dropped.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from repro_torch.obs import tracer as trace

from ..core.stats import ServiceStats

__all__ = ["SharedResidency", "session_still_needs"]

#: Epoch stride in schedule positions: positions are ``epoch * _EPOCH_STRIDE
#: + index``, so claims of epoch ``e`` always rank before epoch ``e+1``'s
#: (the pump runs epochs in order) while staying plain ints.
_EPOCH_STRIDE = 1 << 40


def session_still_needs(cluster, chunk: int) -> bool:
    """Exact liveness test: will ``cluster`` load ``chunk`` again this epoch?

    True iff some member file is neither consumed nor currently resident at
    the chunk's owner node. Residency can only be created by loading the
    chunk itself (redirection changes *which* file a slot returns, never
    which chunk a file lives in), so this is an iff, not an approximation.
    """
    plan = cluster.plan
    g = int(plan.group_of_chunk[chunk])
    node = cluster.nodes[int(cluster.owner_of_group[g])]
    files = plan.chunk_files[chunk]
    locs = g * plan.chunk_size + np.arange(plan.chunk_size)
    need = (
        plan.chunk_valid[chunk]
        & ~node.consumed[plan.chunk_files_clipped[chunk]]
        & (node.memory.resident_flat[locs] != files)
    )
    return bool(need.any())


class _Entry:
    """One resident chunk: the store's *cacheable* payload — a compressed
    :class:`~repro.core.storage.ChunkFrame` on framed stores, the raw blob
    (or, for stores without the raw/decode split, the decoded record list)
    otherwise. ``nbytes`` is the payload's physical footprint: the byte cap
    counts compressed bytes, which is exactly the codec's capacity win."""

    __slots__ = ("payload", "nbytes", "seq")

    def __init__(self, payload, nbytes: int, seq: int):
        self.payload = payload
        self.nbytes = nbytes
        self.seq = seq


class SharedResidency:
    """Refcount/liveness-managed chunk-byte cache shared by all sessions."""

    def __init__(
        self,
        store,
        *,
        cache_limit_bytes: "int | None" = None,
        eviction: str = "belady",
    ):
        if eviction not in ("belady", "lru"):
            raise ValueError(
                f"unknown eviction policy {eviction!r}; expected 'belady' or 'lru'"
            )
        self.store = store
        self.cache_limit_bytes = cache_limit_bytes
        self.eviction = eviction
        # Stores exposing the raw/decode split (ChunkStore) are cached as
        # compressed payloads and decoded per-claim; anything else (test
        # doubles, wrappers) falls back to caching decoded records.
        self._raw_reader = getattr(store, "read_chunk_raw", None)
        self._decoder = getattr(store, "decode_chunk", None)
        self._framed = bool(getattr(getattr(store, "spec", None), "framed", False))
        self._entries: "dict[int, _Entry]" = {}
        self._inflight: "dict[int, threading.Event]" = {}
        self._lock = threading.RLock()
        # Planned mode: outstanding claim counts. _refs[k] sums every
        # pool's remaining claims of chunk k; pools are keyed per
        # (job, epoch) so jobs running different epochs concurrently never
        # touch each other's accounting (chunk bytes are epoch-invariant,
        # so cross-epoch refs sharing the one _refs map is correct).
        self._refs: "dict[int, int]" = {}
        self._claims_left: "dict[tuple, dict[int, int]]" = {}
        # Next-use index (Belady): per chunk, the ascending schedule
        # positions of its future planned claims, drained head-first as
        # claims are served. Installed per epoch from the merged multi-job
        # claim order; a chunk absent here has no planned next use.
        self._next_use: "dict[int, deque[int]]" = {}
        self._sched_epochs: "set[int]" = set()
        #: Planned claims served so far (positions drained). Exposed for the
        #: eviction property tests, which replay the schedule offline.
        self.claims_drained = 0
        #: When set to a list (tests/benchmarks), every eviction decision is
        #: appended as a dict: victim, its next-use position, the incoming
        #: chunk + position, the residents' positions, and claims_drained —
        #: enough to check the choice against the ground-truth future.
        self.eviction_log: "list[dict] | None" = None
        # Live mode: callback(chunk) -> True while any live session needs it.
        self._liveness = None
        self._seq = 0
        self.cache_bytes = 0
        self.peak_cache_bytes = 0
        self.evictions = 0
        self.cache_bypass = 0
        self._job_stats: "dict[object, ServiceStats]" = {}

    # ------------------------------------------------------------ bookkeeping
    def set_liveness(self, fn) -> None:
        self._liveness = fn

    def job_stats(self, job) -> ServiceStats:
        with self._lock:
            return self._job_stats.setdefault(job, ServiceStats())

    @property
    def per_job_stats(self) -> "dict[object, ServiceStats]":
        with self._lock:
            return dict(self._job_stats)

    def is_cached(self, chunk: int) -> bool:
        return chunk in self._entries

    def has_claims(self) -> bool:
        """True while any planned claims are outstanding."""
        with self._lock:
            return bool(self._refs)

    def install_claims(self, job, epoch: int, counts: "dict[int, int]") -> None:
        """Register ``job``'s planned per-chunk claim counts for ``epoch``
        (the plan-time install — keep-first: an existing pool, possibly
        partially drained by a running stream, is left untouched)."""
        key = (job, int(epoch))
        with self._lock:
            if key in self._claims_left:
                return
            self._install_pool_locked(key, counts)

    def install_schedule(self, epoch: int, claims: "list[int]") -> None:
        """Register the merged multi-job claim *order* for ``epoch`` — the
        Belady next-use index. ``claims`` is ``merge_read_schedules``'s
        output: every planned claim of every replay session, duplicates
        included, in pump lockstep order. Keep-first per epoch, mirroring
        :meth:`install_claims`: a re-plan of an epoch whose schedule is
        already draining must not duplicate positions. The epoch is retired
        (and reinstallable) once no claim pool for it remains — the
        end-of-epoch sweep handles that."""
        epoch = int(epoch)
        with self._lock:
            if epoch in self._sched_epochs:
                return
            self._sched_epochs.add(epoch)
            base = epoch * _EPOCH_STRIDE
            for i, k in enumerate(claims):
                self._next_use.setdefault(int(k), deque()).append(base + i)

    def next_use(self, chunk: int) -> "int | None":
        """The chunk's next planned claim position (None: no planned use)."""
        with self._lock:
            d = self._next_use.get(int(chunk))
            return int(d[0]) if d else None

    def begin_epoch_claims(self, job, epoch: int, counts: "dict[int, int]") -> None:
        """Atomically retire ``job``'s claim pools up to and including the
        epoch it is starting (drained ones from completed epochs, stale
        ones from skipped or abandoned epochs) and install the exact pool
        for that epoch. Pools for epochs the job has not reached yet are
        kept — they may have been planned ahead and their refs are what
        pins bytes for the job's future epochs. The sweep runs after the
        install, so entries pinned by the old pool for the *same* epoch
        stay resident through the swap (cross-epoch sharing)."""
        key = (job, int(epoch))
        with self._lock:
            for stale in [
                k for k in self._claims_left
                if k[0] == job and k[1] <= int(epoch)
            ]:
                self._unwind_locked(stale)
            self._install_pool_locked(key, counts)
            self._sweep_locked()

    def _install_pool_locked(self, key, counts: "dict[int, int]") -> None:
        pool: "dict[int, int]" = {}
        for k, n in counts.items():
            k, n = int(k), int(n)
            pool[k] = pool.get(k, 0) + n
            self._refs[k] = self._refs.get(k, 0) + n
        self._claims_left[key] = pool

    def drop_claims(self, job, epoch: "int | None" = None) -> None:
        """Unwind a job's outstanding claims (one epoch, or all of them for
        a closed/killed job) and sweep the cache."""
        with self._lock:
            keys = [
                key for key in self._claims_left
                if key[0] == job and (epoch is None or key[1] == epoch)
            ]
            for key in keys:
                self._unwind_locked(key)
            self._sweep_locked()

    def _unwind_locked(self, key) -> None:
        for k, n in self._claims_left.pop(key, {}).items():
            left = self._refs.get(k, 0) - n
            if left > 0:
                self._refs[k] = left
            else:
                self._refs.pop(k, None)

    def end_epoch(self) -> None:
        """Release everything no longer needed (planned refs drain to zero on
        their own; live-mode entries are re-evaluated here because liveness
        is only probed lazily, at claim time)."""
        with self._lock:
            self._sweep_locked()

    # ----------------------------------------------------------------- claims
    def _read_physical(self, chunk: int):
        """One storage read, in the store's cacheable form."""
        if self._raw_reader is not None:
            return self._raw_reader(chunk)
        return list(self.store.read_chunk(chunk))

    def _payload_nbytes(self, chunk: int, payload) -> int:
        """Physical footprint of a cacheable payload (compressed bytes on
        framed stores; logical plan bytes for fallback record lists)."""
        if self._raw_reader is None:
            return int(self.store.plan.chunk_bytes[chunk])
        physical = getattr(payload, "physical_bytes", None)
        if physical is not None:
            return int(physical)
        return memoryview(payload).nbytes

    def _decode_claim(self, st: ServiceStats, chunk: int, payload, fidelity):
        """Per-claim decode, outside the lock: every claim of a framed
        chunk decompresses its own copy so the cache itself only ever
        holds compressed bytes."""
        if self._decoder is None:
            records = payload  # fallback stores cache decoded records
        else:
            t0 = time.perf_counter()
            records = self._decoder(chunk, payload, fidelity)
            decode_s = time.perf_counter() - t0
        logical = sum(len(b) for _, b in records)
        with self._lock:
            st.logical_bytes += logical
            if self._framed:
                st.decode_claims += 1
                st.decode_s += decode_s
        return records

    def read_chunk(
        self,
        job,
        chunk: int,
        *,
        epoch: "int | None" = None,
        fidelity: "int | None" = None,
    ):
        """Serve one chunk claim for ``job`` (consuming epoch ``epoch``):
        shared-cache hit or physical read. Returns the store's
        ``[(file_id, bytes), ...]`` records, decoded at the claiming
        session's ``fidelity`` (None: the store's default)."""
        chunk = int(chunk)
        tracer = trace.get()
        t0 = time.perf_counter() if tracer is not None else 0.0
        st = self.job_stats(job)
        while True:
            with self._lock:
                e = self._entries.get(chunk)
                if e is not None:
                    self._note_claim_locked(job, epoch, chunk)
                    st.shared_hits += 1
                    st.shared_bytes += e.nbytes
                    self._seq += 1
                    e.seq = self._seq
                    payload = e.payload
                    self._maybe_release_locked(chunk)
                    hit = True
                    break
                ev = self._inflight.get(chunk)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[chunk] = ev
                    hit = False
                    break
            # Another session is already reading this chunk; wait for its
            # insert, then retry (shared hit, or read ourselves if it chose
            # not to retain).
            ev.wait()
        if hit:
            records = self._decode_claim(st, chunk, payload, fidelity)
            if tracer is not None:
                tracer.complete(
                    "residency.claim", "read", t0,
                    time.perf_counter() - t0,
                    {"chunk": chunk, "hit": True},
                )
            return records
        try:
            payload = self._read_physical(chunk)
            # Decode before insert: the first claim consumes the backend
            # worker's eager decode, so the payload that gets cached is
            # stripped back to compressed bytes only.
            records = self._decode_claim(st, chunk, payload, fidelity)
        except BaseException:
            with self._lock:
                self._inflight.pop(chunk, None)
            ev.set()
            raise
        nbytes = self._payload_nbytes(chunk, payload)
        with self._lock:
            self._note_claim_locked(job, epoch, chunk)
            st.physical_reads += 1
            st.physical_bytes += nbytes
            self._inflight.pop(chunk, None)
            if self._retain_locked(chunk):
                self._insert_locked(job, chunk, payload, nbytes)
            ev.set()
        if tracer is not None:
            tracer.complete(
                "residency.claim", "read", t0, time.perf_counter() - t0,
                {"chunk": chunk, "hit": False},
            )
        return records

    # -------------------------------------------------------------- internals
    def _note_claim_locked(self, job, epoch: "int | None", chunk: int) -> None:
        mine = None if epoch is None else self._claims_left.get((job, epoch))
        if mine is None or chunk not in mine:
            return  # live-mode claim (or unplanned repeat): liveness-driven
        mine[chunk] -= 1
        if mine[chunk] <= 0:
            del mine[chunk]
        left = self._refs.get(chunk, 0) - 1
        if left > 0:
            self._refs[chunk] = left
        else:
            self._refs.pop(chunk, None)
        # Drain the next-use index in step with the claims. Positions are
        # popped smallest-first per chunk — claims of the same chunk are
        # interchangeable across jobs, so per-job attribution of positions
        # is unnecessary.
        d = self._next_use.get(chunk)
        if d:
            d.popleft()
            if not d:
                del self._next_use[chunk]
        self.claims_drained += 1

    def _retain_locked(self, chunk: int) -> bool:
        if self._refs.get(chunk, 0) > 0:
            return True
        return bool(self._liveness is not None and self._liveness(chunk))

    def _maybe_release_locked(self, chunk: int) -> None:
        if chunk in self._entries and not self._retain_locked(chunk):
            self.cache_bytes -= self._entries.pop(chunk).nbytes

    def _sweep_locked(self) -> None:
        for chunk in list(self._entries):
            self._maybe_release_locked(chunk)
        # Prune the next-use index: positions of chunks with no outstanding
        # planned claims are stale by definition (their pools drained or
        # were unwound). Epochs with no remaining pool are retired so a
        # re-run of the same epoch reinstalls a fresh schedule.
        for chunk in [k for k, _ in self._next_use.items()
                      if self._refs.get(k, 0) == 0]:
            del self._next_use[chunk]
        if self._sched_epochs:
            active = {key[1] for key in self._claims_left}
            self._sched_epochs &= active

    # ------------------------------------------------------------- eviction
    def _next_pos_locked(self, chunk: int) -> "int | None":
        d = self._next_use.get(chunk)
        return d[0] if d else None

    def _victim_locked(self) -> "tuple[int, int | None]":
        """The entry the active policy evicts next.

        * ``belady`` — farthest (or absent) next planned use wins; entries
          with no planned use tie-break least-recently-claimed, so a
          live-only cache (no schedule installed) degrades exactly to LRU.
        * ``lru`` — least-recently-claimed, period (the differential
          baseline).
        """
        if self.eviction == "lru":
            victim = min(self._entries, key=lambda k: self._entries[k].seq)
            return victim, self._next_pos_locked(victim)
        best_key, victim, victim_next = None, None, None
        for k, e in self._entries.items():
            nxt = self._next_pos_locked(k)
            # Rank: absent next use beats any position; among absents the
            # smallest seq (least-recently-claimed) wins; among planned
            # entries the farthest position wins.
            key = (1, -e.seq) if nxt is None else (0, nxt)
            if best_key is None or key > best_key:
                best_key, victim, victim_next = key, k, nxt
        return victim, victim_next

    def _bypass_locked(self, st: ServiceStats, chunk: int, reason: str) -> None:
        """Account a refused insert — never a silent drop (DESIGN §13)."""
        self.cache_bypass += 1
        st.cache_bypass += 1
        trace.instant("residency.cache_bypass", "read", chunk=chunk, reason=reason)

    def _insert_locked(self, job, chunk: int, payload, nbytes: int) -> None:
        st = self.job_stats(job)
        limit = self.cache_limit_bytes
        if limit is not None:
            if nbytes > limit:
                # a single chunk over the whole budget: never cacheable
                self._bypass_locked(st, chunk, "oversized")
                return
            incoming_next = self._next_pos_locked(chunk)
            while self._entries and self.cache_bytes + nbytes > limit:
                victim, victim_next = self._victim_locked()
                if self.eviction == "belady" and victim_next is not None and (
                    incoming_next is None or victim_next < incoming_next
                ):
                    # Every resident (the farthest included) is needed
                    # sooner than the incoming chunk: admitting it could
                    # only trade a nearer hit for a farther one. Serve the
                    # claim uncached instead.
                    self._bypass_locked(st, chunk, "farther_next_use")
                    return
                if self.eviction_log is not None:
                    self.eviction_log.append({
                        "victim": victim,
                        "victim_next": victim_next,
                        "incoming": chunk,
                        "incoming_next": incoming_next,
                        "residents": {
                            k: self._next_pos_locked(k) for k in self._entries
                        },
                        "claims_drained": self.claims_drained,
                        "by": job,
                    })
                self.cache_bytes -= self._entries.pop(victim).nbytes
                self.evictions += 1
                st.evictions += 1  # attributed to the claiming job
                trace.instant(
                    "residency.evict", "read",
                    chunk=victim, by=str(job), policy=self.eviction,
                )
            if self.cache_bytes + nbytes > limit:
                self._bypass_locked(st, chunk, "over_limit")
                return
        self._seq += 1
        self._entries[chunk] = _Entry(payload, nbytes, self._seq)
        self.cache_bytes += nbytes
        self.peak_cache_bytes = max(self.peak_cache_bytes, self.cache_bytes)
