"""Redox local data-access protocol (paper §3.3, Fig. 4).

The four mechanisms, verbatim from the paper:

* **Random chunk fill** — on a miss at (group g, slot s) the system may
  bring in *any* chunk of group g that can serve slot s, and returns *any*
  file at slot s. Redirection: the returned file need not be the requested
  one. §4.1 proves the stream is still a uniform exactly-once permutation;
  ``tests/test_randomness_property.py`` checks this empirically.
* **Self-invalidation** — a file leaves memory the moment it is returned
  (every file is consumed exactly once per epoch).
* **Return current valid file** — if slot s holds *any* valid file, return
  it. Guarantees every batched-in byte is eventually consumed.
* **Never-evict + fill-rate refill** — a resident file is never displaced.
  A refill merges the chosen chunk's *fillable* files (not consumed, slot
  empty) into the abstract chunk; the chunk is chosen to maximise
  ``fill_rate = fillable / chunk_size`` among candidates that can serve the
  missed slot, ties broken uniformly at random. ``policy="random"``
  reproduces the paper's Brand-random-selection ablation.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from .abstract_memory import AbstractMemory
from .chunking import ChunkingPlan
from .stats import NodeStats, StepIO

__all__ = ["LocalNode", "RequestResult"]

# Batched engines evaluate hit runs in blocks of this many accesses: large
# enough to amortise the NumPy call overhead, small enough that the rescan
# after each protocol event stays cheap during miss-heavy epoch prefixes.
_SCAN_BLOCK = 128


def _prev_occurrence(values: np.ndarray) -> np.ndarray:
    """``prev[j]``: largest ``j' < j`` with ``values[j'] == values[j]``, or -1.

    Lets the batched engines test "first occurrence since index i" as the
    O(1) comparison ``prev[j] < i`` instead of re-uniquing every scan.
    """
    prev = np.full(values.size, -1, dtype=np.int64)
    if values.size > 1:
        order = np.argsort(values, kind="stable")
        sorted_vals = values[order]
        same = sorted_vals[1:] == sorted_vals[:-1]
        prev[order[1:][same]] = order[:-1][same]
    return prev


@dataclasses.dataclass
class RequestResult:
    """Outcome of one data request."""

    file_id: int              # the (possibly redirected) file returned
    requested: int            # the file the framework asked for
    hit: bool                 # True -> served without a chunk load
    chunk_loaded: int | None  # chunk id batched in, if any
    fill_rate: float | None   # fill rate of that load, if any
    io: StepIO                # I/O demand generated by this request
    data: bytes | None = None  # record payload when a ChunkStore is attached


class LocalNode:
    """Single-node Redox server: abstract memory + the access protocol.

    In the distributed setting (``core/distributed.py``) one ``LocalNode``
    instance runs per owner node and is only ever asked about the groups it
    owns; the protocol is identical (paper §3.4: "the owner node follows the
    local procedure").
    """

    def __init__(
        self,
        plan: ChunkingPlan,
        *,
        policy: str = "max_fill",
        seed: int = 0,
        store=None,
        node_id: int = 0,
    ):
        if policy not in ("max_fill", "random"):
            raise ValueError(f"unknown refill policy {policy!r}")
        self.plan = plan
        self.policy = policy
        self.seed = seed
        self.node_id = node_id
        self.rng = np.random.default_rng(seed)
        self.memory = AbstractMemory(plan.num_groups, plan.chunk_size, plan.file_sizes)
        self.consumed = np.zeros(plan.num_files, dtype=bool)
        self.stats = NodeStats()
        # Optional real-bytes mode: when a ChunkStore is attached, resident
        # files carry their payloads (this is the abstract memory's physical
        # backing; the simulation-only mode tracks ids and byte *counts*).
        self.store = store
        self.buffer: dict[int, bytes] = {}
        # Optional planner hook (core/planner.py): when set, every chunk load
        # is reported so an EpochPlan can capture the exact read schedule.
        self.recorder = None
        # Optional refill-choice hook (repro/service: co-refill across jobs).
        # Called as ``refill_filter(group, candidate_chunk_ids)`` with the
        # protocol's own candidate pool (max-fill ties under ``max_fill``,
        # all candidates under ``random``); may return a non-empty subset to
        # restrict the uniform tie-break, or None/empty to leave the choice
        # untouched. Restricting to a subset of the pool keeps the fill-rate
        # optimality and the §4.1 uniformity argument intact as long as the
        # hook's preference is independent of this node's own sequence
        # (DESIGN.md §9). With no hook the RNG stream is bit-identical to
        # the hook-free protocol.
        self.refill_filter = None

    # ------------------------------------------------------------ lifecycle
    def begin_epoch(self, epoch: int | None = None) -> None:
        """Reset per-epoch state. Memory must already be drained.

        The exactly-once property guarantees the abstract memory is empty at
        epoch end (every resident file was eventually consumed); we assert
        it rather than flushing, to catch protocol bugs.

        When ``epoch`` is given, the refill RNG is re-derived from
        ``(seed, epoch)``. This makes each epoch's protocol run a pure
        function of ``(plan, policy, seed, epoch, sequence)`` — the property
        the clairvoyant planner relies on: any node can compute the entire
        epoch's I/O schedule up front without replaying prior epochs (paper
        §3.4: sequences are pre-shared and the protocol is deterministic).
        Without ``epoch`` (standalone use) the RNG stream simply continues.
        """
        assert self.memory.is_empty(), "abstract memory not drained at epoch start"
        self.consumed[:] = False
        self.stats = NodeStats()
        # NodeStats are per-epoch quantities; the drained memory's peak
        # restarts with them (otherwise epoch e's reported peak would carry
        # earlier epochs', breaking plan-epoch independence).
        self.memory.peak_bytes = self.memory.used_bytes
        if epoch is not None:
            seed = self.seed if isinstance(self.seed, tuple) else (self.seed,)
            self.rng = np.random.default_rng((*seed, epoch))

    # ------------------------------------------------------------- protocol
    def request(self, file_id: int) -> RequestResult:
        """Serve one access from the framework's random sequence."""
        plan = self.plan
        g = plan.group_of_file(file_id)
        s = int(plan.slot_of[file_id])
        self.stats.accesses += 1
        io = StepIO()

        resident = self.memory.get(g, s)
        if resident >= 0:
            # "Return current valid file from in-memory chunk" + self-invalidation.
            self.stats.local_hits += 1
            returned = self._consume(g, s)
            data = self.buffer.pop(returned) if self.store is not None else None
            return RequestResult(returned, file_id, True, None, None, io, data)

        # Miss: refill a chunk from the group, then serve the slot.
        self.stats.memory_misses += 1
        chunk, fill_rate = self._choose_refill_chunk(g, s)
        self._load_chunk(g, chunk, fill_rate, io)
        returned = self._consume(g, s)
        data = self.buffer.pop(returned) if self.store is not None else None
        return RequestResult(returned, file_id, False, chunk, fill_rate, io, data)

    def request_step(
        self,
        file_ids: np.ndarray,
        io: StepIO,
        *,
        payloads: "list | None" = None,
        locs: "np.ndarray | None" = None,
    ) -> np.ndarray:
        """Serve a whole step's worth of accesses, batched (id-space).

        Byte-identical to calling :meth:`request` once per id, but runs of
        consecutive *hits* — the common case once chunks are resident — are
        executed as NumPy scatter/gather operations instead of a per-file
        Python loop. Only misses (which draw from the refill RNG and mutate
        whole groups) fall back to the per-access path, preserving the exact
        RNG stream and therefore the exact redirection decisions.

        ``io`` accumulates the step's I/O demand; ``payloads`` (real-bytes
        mode) receives each returned record's bytes in consumption order;
        ``locs`` optionally passes the precomputed abstract locations.
        """
        fids = np.asarray(file_ids, dtype=np.int64)
        n = int(fids.size)
        out = np.empty(n, dtype=np.int64)
        if n == 0:
            return out
        if locs is None:
            locs = self.plan.locations_of_files(fids)
        prev = _prev_occurrence(locs)
        resident = self.memory.resident_flat
        i = 0
        while i < n:
            j = min(i + _SCAN_BLOCK, n)
            sub_loc = locs[i:j]
            # A position is a *safe* bulk hit iff its slot currently holds a
            # valid file AND no earlier position in this run targets the same
            # location (the earlier hit self-invalidates the slot).
            safe = (resident[sub_loc] >= 0) & (prev[i:j] < i)
            k = int(safe.argmin())
            run = j - i if safe[k] else k
            if run:
                returned = self.memory.take_many_flat(sub_loc[:run])
                self.consumed[returned] = True
                self.stats.accesses += run
                self.stats.local_hits += run
                self.stats.peak_local_bytes = max(
                    self.stats.peak_local_bytes, self.memory.peak_bytes
                )
                out[i : i + run] = returned
                if self.store is not None:
                    for f in returned.tolist():
                        data = self.buffer.pop(f)
                        if payloads is not None:
                            payloads.append(data)
                i += run
                if run == j - (i - run):  # block exhausted by hits
                    continue
            if i >= n:
                break
            # Breaker: a genuine miss (invalid slot, or its in-run duplicate
            # predecessor was just consumed, which empties the slot too).
            r1 = self.request(int(fids[i]))
            io.add(r1.io)
            out[i] = r1.file_id
            if payloads is not None:
                payloads.append(r1.data)
            i += 1
        return out

    # -------------------------------------------------------------- helpers
    def _consume(self, group: int, slot: int) -> int:
        file_id = self.memory.take(group, slot)
        assert not self.consumed[file_id]
        self.consumed[file_id] = True
        self.stats.peak_local_bytes = max(
            self.stats.peak_local_bytes, self.memory.peak_bytes
        )
        return file_id

    def take_for_prefetch(self, group: int, slot: int) -> tuple[int, bytes | None] | None:
        """Ship the resident file at (group, slot) to a remote node.

        Sender-side consumption (paper §3.4): once sent, the file is
        consumed here — the receiver is now responsible for it.
        """
        file_id = self.memory.get(group, slot)
        if file_id < 0:
            return None
        self.memory.take(group, slot)
        assert not self.consumed[file_id]
        self.consumed[file_id] = True
        self.stats.prefetch_sent += 1
        data = self.buffer.pop(file_id) if self.store is not None else None
        return file_id, data

    def _choose_refill_chunk(self, group: int, slot: int) -> tuple[int, float]:
        """One fused pass over the group's chunks (the per-miss hot path).

        A candidate chunk holds an unconsumed file at the missed slot; its
        fill count is the number of its files that are unconsumed *and*
        whose slot is empty. Identical decisions (and RNG draws) to the
        textbook candidates/fill-masks formulation, one array pass.
        """
        plan = self.plan
        start, end = plan.group_chunk_range(group)
        # (m, c): files of each group chunk that could still land in memory.
        fillable = (
            plan.chunk_valid[start:end]
            & ~self.consumed[plan.chunk_files_clipped[start:end]]
        )
        cands = np.nonzero(fillable[:, slot])[0]
        assert cands.size > 0, (
            "protocol invariant violated: a miss implies at least one group "
            "chunk still holds an unconsumed file at the missed slot"
        )
        c = plan.chunk_size
        if self.policy == "max_fill":
            counts = (
                fillable[cands] & self.memory.group_empty_mask(group)[None, :]
            ).sum(axis=1)
            best = int(counts.max())
            pool = cands[counts == best]
            pool = self._apply_refill_filter(group, start, pool)
            choice = int(start + pool[self.rng.integers(pool.size)])
            return choice, best / c
        # "random" ablation: uniform over candidates.
        pool = self._apply_refill_filter(group, start, cands)
        k = int(pool[self.rng.integers(pool.size)])
        count = int((fillable[k] & self.memory.group_empty_mask(group)).sum())
        return start + k, count / c

    def _apply_refill_filter(self, group: int, start: int, pool: np.ndarray) -> np.ndarray:
        """Narrow the tie-break pool through the pluggable refill hook.

        An empty/None answer (or one containing no pool member) leaves the
        pool — and therefore the RNG draw — exactly as without a hook.
        """
        if self.refill_filter is None or pool.size <= 1:
            return pool
        keep = self.refill_filter(group, start + pool)
        if keep is None:
            return pool
        keep = np.asarray(keep, dtype=np.int64)
        narrowed = pool[np.isin(start + pool, keep)]
        return narrowed if narrowed.size else pool

    def _refill_hints(self, group: int, loading: int) -> "list[int]":
        """Group chunks that still need a future load, best-first.

        A chunk will be re-chosen by some later refill iff it still holds a
        file that is neither consumed nor resident. Ranking by that count
        approximates the max-fill choice the protocol will make, so hinting
        these to the backend turns misses into readahead (paper §3.3's
        batched loads, overlapped instead of serialized).
        """
        start, end = self.plan.group_chunk_range(group)
        files = self.plan.chunk_files[start:end]  # (m, c)
        resident = self.memory.resident[group][None, :]
        needs = (
            (files >= 0)
            & ~self.consumed[np.maximum(files, 0)]
            & (files != resident)
        )
        counts = needs.sum(axis=1)
        order = np.argsort(-counts, kind="stable")
        return [
            int(start + i) for i in order
            if counts[i] > 0 and int(start + i) != loading
        ]

    def _load_chunk(self, group: int, chunk: int, fill_rate: float, io: StepIO) -> None:
        """Batched read of ``chunk`` + merge into the abstract chunk (Fig. 4)."""
        plan = self.plan
        files = plan.chunk_files[chunk]
        mask = (
            plan.chunk_valid[chunk]
            & ~self.consumed[plan.chunk_files_clipped[chunk]]
            & self.memory.group_empty_mask(group)
        )
        records = None
        if self.store is not None:
            # Enqueue the group's likely next refills *before* blocking on
            # this chunk, so an async backend overlaps them with this read
            # and with downstream decode/assembly. Synchronous backends
            # ignore hints — and when a clairvoyant plan already drives the
            # backend's readahead (store.has_schedule), the heuristic is
            # redundant — so skip computing hints entirely in both cases.
            if self.store.wants_prefetch and not self.store.has_schedule:
                self.store.prefetch_chunks(self._refill_hints(group, chunk))
            t0 = time.perf_counter()
            records = dict(self.store.read_chunk(chunk))
            wait = time.perf_counter() - t0
            self.stats.read_wait_s += wait
            io.read_wait_s += wait
            self.stats.peak_inflight_reads = max(
                self.stats.peak_inflight_reads,
                self.store.backend_stats.peak_inflight,
            )
        js = np.nonzero(mask)[0]
        fill_files = files[js]
        self.memory.fill_many(group, js, fill_files)
        filled = int(plan.file_sizes[fill_files].sum())
        if records is not None:
            for f in fill_files:
                self.buffer[int(f)] = records[int(f)]
        if self.recorder is not None:
            self.recorder.on_load(self.node_id, chunk, fill_rate, fill_files)
        total = int(plan.chunk_bytes[chunk])
        self.stats.chunk_loads += 1
        self.stats.disk_bytes += total
        self.stats.filled_bytes += filled
        self.stats.wasted_bytes += total - filled
        self.stats.fill_rate_num += fill_rate
        io.chunk_loads += 1
        io.disk_bytes += total

    # --------------------------------------------------------------- checks
    def epoch_complete(self) -> bool:
        return bool(self.consumed.all()) and self.memory.is_empty()
