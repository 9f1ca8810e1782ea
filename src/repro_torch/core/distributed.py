"""Distributed Redox: ownership, remote access, opportunistic prefetch (paper §3.4).

Memory organisation (Fig. 5): every node shares one view of the global
abstract memory. Each abstract chunk (= chunk group) has a single *owner*
node which also stores the group's chunks on its local disk. Owners run the
unmodified local protocol; non-owners reach a group only through its owner.

Opportunistic prefetch (Fig. 6): on a remote miss the requester piggybacks
its current sequence position and its remaining remote-memory budget. The
owner serves the miss via the local protocol, then walks the requester's
*pre-shared* access sequence over the next ``prefetch_window`` positions and
ships any file that (a) it owns, (b) is already resident in its abstract
memory (opportunistic — never loads from disk for a prefetch), (c) whose
abstract location is provably vacant on the requester ("Prefetch Check
List": no outstanding prefetch to that location), and (d) fits the
requester's remote-memory budget. A shipped file is consumed at the sender
immediately — which empties sender slots early and *raises* later refill
fill-rates (Fig. 7's positive side-effect).

Fault tolerance: :meth:`Cluster.remap_ownership` implements the elastic
ownership remap described in DESIGN.md §5 — on node loss the dead node's
groups are reassigned to survivors, its *memory* contents are lost (those
files were not yet consumed, so the new owner simply re-fetches them from
the replicated chunk store), and its consumption journal (4 bytes/file,
durably logged in any real deployment) is recovered so exactly-once is
preserved.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.obs import tracer as trace

from .chunking import ChunkingPlan
from .protocol import _SCAN_BLOCK, LocalNode, _prev_occurrence
from .sampler import EpochSampler
from .stats import NodeStats, StepIO

__all__ = ["Cluster", "EpochResult", "RemoteMemory"]




class RemoteMemory:
    """Requester-side bounded cache of prefetched files, keyed by location.

    Backed by a dense ``location -> file_id`` array so the batched access
    engine can test/consume whole runs of remote-prefetch hits with gather/
    scatter operations; payload bytes (real-bytes mode only) live in a side
    dict keyed by location.
    """

    def __init__(self, limit_bytes: int, file_sizes: np.ndarray, num_locs: int):
        self.limit_bytes = int(limit_bytes)
        self._sizes = file_sizes
        self._loc_file = np.full(int(num_locs), -1, dtype=np.int64)
        self._payloads: dict[int, bytes] = {}
        self._count = 0
        self.used_bytes = 0
        self.peak_bytes = 0

    def __contains__(self, loc: int) -> bool:
        return self._loc_file[loc] >= 0

    @property
    def free_bytes(self) -> int:
        return self.limit_bytes - self.used_bytes

    def put(self, loc: int, file_id: int, data: bytes | None = None) -> None:
        size = int(self._sizes[file_id])
        assert self._loc_file[loc] < 0, "prefetch landed on an occupied location"
        assert size <= self.free_bytes, "prefetch overran the remote-memory budget"
        self._loc_file[loc] = file_id
        if data is not None:
            self._payloads[loc] = data
        self._count += 1
        self.used_bytes += size
        self.peak_bytes = max(self.peak_bytes, self.used_bytes)

    def take(self, loc: int) -> tuple[int, bytes | None]:
        file_id = int(self._loc_file[loc])
        assert file_id >= 0, "take() on an empty remote location"
        self._loc_file[loc] = -1
        self._count -= 1
        self.used_bytes -= int(self._sizes[file_id])
        return file_id, self._payloads.pop(loc, None)

    # ------------------------------------------------------- batched variants
    def file_at(self, locs: np.ndarray) -> np.ndarray:
        """Vectorised lookup: file id held at each location, or -1."""
        return self._loc_file[locs]

    def put_many(self, locs: np.ndarray, file_ids: np.ndarray) -> None:
        """Vectorised :meth:`put` of distinct empty locations (bulk ship)."""
        sizes = int(self._sizes[file_ids].sum())
        assert (self._loc_file[locs] < 0).all(), (
            "prefetch landed on an occupied location"
        )
        assert sizes <= self.free_bytes, "prefetch overran the remote-memory budget"
        self._loc_file[locs] = file_ids
        self._count += int(locs.size)
        self.used_bytes += sizes
        self.peak_bytes = max(self.peak_bytes, self.used_bytes)

    def store_payload(self, loc: int, data: bytes) -> None:
        """Attach the payload for a location filled via :meth:`put_many`."""
        self._payloads[loc] = data

    def take_many(self, locs: np.ndarray) -> np.ndarray:
        """Vectorised :meth:`take` of distinct occupied locations.

        Payloads are *not* popped — the real-bytes caller drains them with
        :meth:`pop_payload` while flattening the batch.
        """
        files = self._loc_file[locs]
        assert (files >= 0).all(), "take_many() on an empty remote location"
        self._loc_file[locs] = -1
        self._count -= int(locs.size)
        self.used_bytes -= int(self._sizes[files].sum())
        return files

    def pop_payload(self, loc: int) -> bytes | None:
        return self._payloads.pop(loc, None)

    def locations(self) -> np.ndarray:
        """Occupied locations (ascending)."""
        return np.nonzero(self._loc_file >= 0)[0]

    def __len__(self) -> int:
        return self._count


@dataclasses.dataclass
class EpochResult:
    stats: NodeStats                      # cluster-wide aggregate
    node_stats: list[NodeStats]
    per_node_step_io: list[list[StepIO]]  # input to PipelineTimeModel
    returned: list[np.ndarray]            # per node: files actually consumed


class Cluster:
    """In-process distributed Redox cluster (protocol-exact, timing-modelled).

    Flags reproduce the paper's ablations (Table 4/5):

    * ``policy="max_fill", prefetch=True``   -> Brand
    * ``policy="random",   prefetch=True``   -> Brand-random-selection
    * ``policy="max_fill", prefetch=False``  -> Brand-no-prefetching
    * ``policy="random",   prefetch=False``  -> Brand-no-optimization
    """

    def __init__(
        self,
        plan: ChunkingPlan,
        num_nodes: int,
        *,
        remote_memory_limit_bytes: int = 1 << 62,
        prefetch_window: int = 64,
        policy: str = "max_fill",
        prefetch: bool = True,
        seed: int = 0,
        store=None,
    ):
        self.plan = plan
        self.num_nodes = num_nodes
        self.prefetch_window = prefetch_window
        self.prefetch = prefetch
        self.policy = policy
        self.seed = seed
        # Contiguous group ranges per owner: data is partitioned across node
        # disks before training (paper §3.4).
        g = np.arange(plan.num_groups, dtype=np.int64)
        self.owner_of_group = np.minimum(
            g * num_nodes // max(plan.num_groups, 1), num_nodes - 1
        ).astype(np.int32)
        self.nodes = [
            LocalNode(plan, policy=policy, seed=(seed, 7, r), store=store, node_id=r)
            for r in range(num_nodes)
        ]
        self.remote_mem = [
            RemoteMemory(remote_memory_limit_bytes, plan.file_sizes, plan.num_slots)
            for _ in range(num_nodes)
        ]
        self._remote_limit = int(remote_memory_limit_bytes)
        # pending[o][r]: the paper's Prefetch Check List — location ``loc``
        # of r's remote memory has an outstanding prefetch from owner o,
        # sent when r was at sequence position ``pending_sent[o][r][loc]``.
        # Entries are dropped lazily, at the next (o, r) round trip, once the
        # piggybacked position proves the requester consumed the location.
        self.pending: list[list[np.ndarray]] = [
            [np.zeros(plan.num_slots, dtype=bool) for _ in range(num_nodes)]
            for _ in range(num_nodes)
        ]
        self.pending_sent: list[list[np.ndarray]] = [
            [np.zeros(plan.num_slots, dtype=np.int64) for _ in range(num_nodes)]
            for _ in range(num_nodes)
        ]
        self.sequences: list[np.ndarray] | None = None
        self._loc_of_seq: list[np.ndarray] | None = None
        self._owner_of_seq: list[np.ndarray] | None = None
        self._lockeys: list[np.ndarray] | None = None
        self.failed = np.zeros(num_nodes, dtype=bool)
        # Per-node access cursor: how many positions of ``sequences[r]`` have
        # been served. The epoch drivers step nodes by ``batch_per_node`` from
        # these cursors (identical to the old fixed step*batch grid for a
        # static cluster) — which is what lets a node join mid-epoch at
        # cursor 0 and a resumed epoch continue from a snapshot's cursors.
        self.positions = np.zeros(num_nodes, dtype=np.int64)
        # Driver bookkeeping consumed by Cluster.snapshot(): the epoch being
        # executed, the next step index, and the step grid in force.
        self.epoch: "int | None" = None
        self.current_step = 0
        self._grid: "tuple[int | None, str | None]" = (None, None)
        self._recorder = None
        # Engine flag: the batched ("step") engine uses the vectorised
        # check-list helpers; the reference per-access engine keeps the
        # scalar originals. Both implement identical protocol semantics —
        # tests/test_planner.py asserts byte-identical runs.
        self._vectorized = True

    def set_recorder(self, recorder) -> None:
        """Attach (or detach, with None) a planner event recorder."""
        self._recorder = recorder
        for node in self.nodes:
            node.recorder = recorder

    @property
    def store(self):
        """The shared ChunkStore (None in simulation-only mode)."""
        return self.nodes[0].store if self.nodes else None

    @property
    def backend_stats(self):
        """Aggregate storage-backend counters, or None without a store.

        All LocalNodes share one store/backend instance (one disk per node is
        modelled by the time model, not by separate backends), so this is the
        cluster-wide view: prefetch hits, peak in-flight reads, and the
        blocking-read throughput that ``benchmarks/io_overhead.py --backend``
        reports per backend.
        """
        store = self.store
        return store.backend_stats if store is not None else None

    def planning_clone(self) -> "Cluster":
        """A fresh, store-less cluster with identical protocol configuration.

        The clairvoyant planner simulates an epoch on the clone (id-space
        only, no bytes touched) to compute the live cluster's exact schedule;
        per-epoch RNG derivation (see :meth:`LocalNode.begin_epoch`) makes
        the clone's epoch-``e`` run identical to the live one regardless of
        which epochs either side executed before.
        """
        return Cluster(
            self.plan,
            self.num_nodes,
            remote_memory_limit_bytes=self._remote_limit,
            prefetch_window=self.prefetch_window,
            policy=self.policy,
            prefetch=self.prefetch,
            seed=self.seed,
        )

    # ------------------------------------------------------------ lifecycle
    def begin_epoch(self, sampler: EpochSampler, epoch: int) -> list[np.ndarray]:
        for node in self.nodes:
            node.begin_epoch(epoch)
        for rm in self.remote_mem:
            assert len(rm) == 0, "remote abstract memory not drained"
            rm.peak_bytes = rm.used_bytes  # per-epoch peak, like NodeStats
        for row in self.pending:
            for mask in row:
                mask[:] = False
        self.positions[:] = 0
        self.epoch = epoch
        self.current_step = 0
        self.sequences = sampler.node_sequences(epoch)
        self._index_sequences()
        return self.sequences

    def _index_sequences(self) -> None:
        """Precompute per-node sequence indexes (rebuilt after fail_node).

        * ``_loc_of_seq[r]`` — abstract location of every position (owners
          look ahead into these to run the opportunistic-prefetch check list
          without extra communication; sequences are pre-shared, §3.4);
        * ``_owner_of_seq[r]`` — owning node of every position;
        * ``_lockeys[r]`` — ``(location << 32) | position`` sorted: lets the
          vectorised check-list cleanup resolve "r's next access of ``loc``
          after position p" for every pending entry in one searchsorted.
        """
        self._loc_of_seq = [self.plan.locations_of_files(s) for s in self.sequences]
        c = self.plan.chunk_size
        self._owner_of_seq = [
            self.owner_of_group[locs // c].astype(np.int64)
            for locs in self._loc_of_seq
        ]
        self._lockeys = [
            np.sort((locs << 32) | np.arange(locs.size, dtype=np.int64))
            for locs in self._loc_of_seq
        ]

    # -------------------------------------------------------------- access
    def access(
        self, r: int, pos: int, file_id: int, io_by_node: dict[int, StepIO]
    ) -> tuple[int, bytes | None]:
        """Node ``r`` performs the access at position ``pos`` of its sequence.

        Returns ``(returned_file_id, payload)`` — the payload is None in
        simulation mode (no ChunkStore attached).
        """
        plan = self.plan
        g = plan.group_of_file(file_id)
        o = int(self.owner_of_group[g])
        stats_r = self.nodes[r].stats
        self.positions[r] = pos + 1

        if o == r:
            res = self.nodes[r].request(file_id)
            io_by_node.setdefault(r, StepIO()).add(res.io)
            return res.file_id, res.data

        loc = plan.location_of_file(file_id)
        rm = self.remote_mem[r]
        if loc in rm:
            # Served by previously prefetched data — no network round trip.
            stats_r.accesses += 1
            stats_r.remote_prefetch_hits += 1
            return rm.take(loc)

        # Remote miss: request the owner (paper Fig. 6).
        stats_r.remote_requests += 1
        self._cleanup_pending(o, r, pos)
        res = self.nodes[o].request(file_id)
        # Owner's batched disk read happens on the owner; the response bytes
        # travel to the requester (see stats.py for the time model).
        io_by_node.setdefault(o, StepIO()).add(res.io)
        io_r = io_by_node.setdefault(r, StepIO())
        io_r.net_messages += 1
        io_r.net_bytes += int(plan.file_sizes[res.file_id])
        if self.prefetch:
            self._opportunistic_prefetch(o, r, pos, io_r)
        return res.file_id, res.data

    def _cleanup_pending(self, o: int, r: int, pos: int) -> None:
        """Drop pending entries the requester has provably consumed (< pos).

        An entry (loc, sent) is retired when r's next access of ``loc``
        strictly after ``sent`` happened before ``pos`` — that access was
        the remote-memory hit that consumed the prefetch. Two equivalent
        implementations: the reference walks entries in Python (the
        original per-access protocol); the batched engine resolves every
        entry with one vectorised searchsorted over ``_lockeys``.

        Elastic events keep entries valid without special cases here:
        ``fail_node``/``join_node`` only ever migrate entries between
        *owners* (requester positions — and therefore ``sent`` — are
        untouched), and an entry whose consuming access is donated to a
        joining node is released outright (see _release_moved_prefetches).
        """
        mask = self.pending[o][r]
        entries = np.nonzero(mask)[0]
        if entries.size == 0:
            return
        keys = self._lockeys[r]
        sent = self.pending_sent[o][r][entries]
        if self._vectorized:
            idx = np.searchsorted(keys, (entries << 32) | sent, side="right")
            valid = idx < keys.size
            nxt = keys[np.minimum(idx, keys.size - 1)]
            drop = valid & (nxt >> 32 == entries) & ((nxt & 0xFFFFFFFF) < pos)
            mask[entries[drop]] = False
            return
        for loc, sent_pos in zip(entries.tolist(), sent.tolist()):
            i = int(np.searchsorted(keys, (loc << 32) | sent_pos, side="right"))
            if i < keys.size:
                nxt = int(keys[i])
                if (nxt >> 32) == loc and (nxt & 0xFFFFFFFF) < pos:
                    mask[loc] = False

    def _opportunistic_prefetch(self, o: int, r: int, pos: int, io_r: StepIO) -> None:
        if self._vectorized:
            return self._opportunistic_prefetch_vec(o, r, pos, io_r)
        return self._opportunistic_prefetch_scalar(o, r, pos, io_r)

    def _opportunistic_prefetch_scalar(
        self, o: int, r: int, pos: int, io_r: StepIO
    ) -> None:
        """Reference implementation: the paper's Fig. 6 walk, one position
        at a time (the per-access engine's event path)."""
        plan = self.plan
        seq = self.sequences[r]
        locs = self._loc_of_seq[r]
        pend = self.pending[o][r]
        rm = self.remote_mem[r]
        owner_mem = self.nodes[o].memory
        end = min(pos + 1 + self.prefetch_window, seq.size)
        for q in range(pos + 1, end):
            gq = plan.group_of_file(int(seq[q]))
            if int(self.owner_of_group[gq]) != o:
                continue
            loc_q = int(locs[q])
            if pend[loc_q]:
                continue  # requester slot occupied by an outstanding prefetch
            sq = loc_q - gq * plan.chunk_size
            file_p = owner_mem.get(gq, sq)
            if file_p < 0:
                continue  # opportunistic: never read disk for a prefetch
            size = int(plan.file_sizes[file_p])
            if size > rm.free_bytes:
                continue  # respect the piggybacked remote-memory budget
            _, data = self.nodes[o].take_for_prefetch(gq, sq)
            rm.put(loc_q, file_p, data)
            pend[loc_q] = True
            self.pending_sent[o][r][loc_q] = pos
            self.nodes[r].stats.prefetch_received += 1
            io_r.net_bytes += size
            self.nodes[r].stats.peak_remote_bytes = max(
                self.nodes[r].stats.peak_remote_bytes, rm.peak_bytes
            )
            if self._recorder is not None:
                self._recorder.on_ship(o, r, file_p, loc_q)

    def _opportunistic_prefetch_vec(
        self, o: int, r: int, pos: int, io_r: StepIO
    ) -> None:
        plan = self.plan
        seq = self.sequences[r]
        locs = self._loc_of_seq[r]
        pend = self.pending[o][r]
        rm = self.remote_mem[r]
        owner_mem = self.nodes[o].memory
        c = plan.chunk_size
        end = min(pos + 1 + self.prefetch_window, seq.size)
        if end <= pos + 1:
            return
        # Candidate filter, vectorised over the whole lookahead window:
        # o-owned, first-occurrence positions whose location has no
        # outstanding prefetch and whose file is resident in the owner's
        # abstract memory (opportunistic — never reads disk for a prefetch).
        # The snapshot stays exact through the walk: ships only *remove*
        # residents, at locations the dedup already excludes from re-use.
        w_locs = locs[pos + 1 : end]
        cand = np.nonzero(
            (self._owner_of_seq[r][pos + 1 : end] == o) & ~pend[w_locs]
        )[0]
        if cand.size == 0:
            return
        # Duplicate locations in the window: only the first may ship (the
        # ship occupies the location; live re-check was via pend).
        cand_locs = w_locs[cand]
        first = np.zeros(cand.size, dtype=bool)
        first[np.unique(cand_locs, return_index=True)[1]] = True
        ship_locs = cand_locs[first]
        gq = ship_locs // c
        sq = ship_locs - gq * c
        files = owner_mem.resident[gq, sq]
        ok = files >= 0
        gq, sq, files, ship_locs = gq[ok], sq[ok], files[ok], ship_locs[ok]
        if files.size == 0:
            return
        sizes = plan.file_sizes[files]
        # Budget walk (greedy, in window order): the all-fits prefix ships
        # in bulk; the remainder falls back to the exact per-file walk
        # (a later smaller file may still fit after a larger one did not).
        fits = np.cumsum(sizes) <= rm.free_bytes
        k = int(fits.sum()) if fits.all() else int(np.argmin(fits))
        if k:
            owner = self.nodes[o]
            shipped = owner.memory.take_many(gq[:k], sq[:k])
            assert not owner.consumed[shipped].any()
            owner.consumed[shipped] = True
            owner.stats.prefetch_sent += k
            rm.put_many(ship_locs[:k], shipped)
            pend[ship_locs[:k]] = True
            self.pending_sent[o][r][ship_locs[:k]] = pos
            if owner.store is not None:
                for f, lc in zip(shipped.tolist(), ship_locs[:k].tolist()):
                    rm.store_payload(lc, owner.buffer.pop(f))
            self.nodes[r].stats.prefetch_received += k
            io_r.net_bytes += int(sizes[:k].sum())
            self.nodes[r].stats.peak_remote_bytes = max(
                self.nodes[r].stats.peak_remote_bytes, rm.peak_bytes
            )
            if self._recorder is not None:
                for f, lc in zip(shipped.tolist(), ship_locs[:k].tolist()):
                    self._recorder.on_ship(o, r, f, lc)
        for gq1, sq1, loc_q, file_p, size in zip(
            gq[k:].tolist(), sq[k:].tolist(), ship_locs[k:].tolist(),
            files[k:].tolist(), sizes[k:].tolist(),
        ):
            if size > rm.free_bytes:
                continue  # respect the piggybacked remote-memory budget
            _, data = self.nodes[o].take_for_prefetch(gq1, sq1)
            rm.put(loc_q, file_p, data)
            pend[loc_q] = True
            self.pending_sent[o][r][loc_q] = pos
            self.nodes[r].stats.prefetch_received += 1
            io_r.net_bytes += size
            self.nodes[r].stats.peak_remote_bytes = max(
                self.nodes[r].stats.peak_remote_bytes, rm.peak_bytes
            )
            if self._recorder is not None:
                self._recorder.on_ship(o, r, file_p, loc_q)

    def access_step(
        self,
        r: int,
        lo: int,
        hi: int,
        io_by_node: dict[int, StepIO],
        *,
        payloads: "list | None" = None,
    ) -> np.ndarray:
        """Node ``r`` performs its sequence positions ``[lo, hi)``, batched.

        Byte-identical to calling :meth:`access` per position: runs of
        consecutive hits — local abstract-memory hits and remote-prefetch
        hits — are consumed with NumPy gather/scatter; only protocol
        *events* (misses, remote round trips, opportunistic ships) drop to
        the per-access path, which preserves the exact RNG draw order.
        """
        n = hi - lo
        out = np.empty(n, dtype=np.int64)
        if n <= 0:
            return out
        fids = np.asarray(self.sequences[r][lo:hi], dtype=np.int64)
        locs = self._loc_of_seq[r][lo:hi]
        owners = self._owner_of_seq[r][lo:hi]
        node = self.nodes[r]
        if (owners == r).all():
            # Whole slice is owner-local (always true for 1-node clusters).
            self.positions[r] = hi
            io = io_by_node.setdefault(r, StepIO())
            return node.request_step(fids, io, payloads=payloads, locs=locs)
        rm = self.remote_mem[r]
        prev = _prev_occurrence(locs)
        resident = node.memory.resident_flat
        i = 0
        while i < n:
            # Scan one block at a time: during the miss-heavy epoch prefix
            # this bounds the per-event vector work; during the hit-heavy
            # remainder runs extend block by block.
            j = min(i + _SCAN_BLOCK, n)
            sub_loc = locs[i:j]
            local = owners[i:j] == r
            res_f = resident[sub_loc]
            rm_f = rm.file_at(sub_loc)
            # Safe bulk hits: a valid local resident (owner-local access) or
            # an already-prefetched remote location — and no earlier position
            # in the run targeting the same location (hits self-invalidate).
            safe = np.where(local, res_f >= 0, rm_f >= 0) & (prev[i:j] < i)
            k = int(safe.argmin())
            run = j - i if safe[k] else k
            if run:
                lm = local[:run]
                ret = np.where(lm, res_f[:run], rm_f[:run])
                n_local = int(lm.sum())
                if n_local:
                    node.memory.take_many_flat(sub_loc[:run][lm])
                    node.consumed[res_f[:run][lm]] = True
                    node.stats.local_hits += n_local
                    node.stats.peak_local_bytes = max(
                        node.stats.peak_local_bytes, node.memory.peak_bytes
                    )
                    io_by_node.setdefault(r, StepIO())
                if run - n_local:
                    rm.take_many(sub_loc[:run][~lm])
                    node.stats.remote_prefetch_hits += run - n_local
                node.stats.accesses += run
                out[i : i + run] = ret
                if node.store is not None:
                    for f, is_local, lc in zip(
                        ret.tolist(), lm.tolist(), sub_loc[:run].tolist()
                    ):
                        data = node.buffer.pop(f) if is_local else rm.pop_payload(lc)
                        if payloads is not None:
                            payloads.append(data)
                i += run
                if run == j - (i - run):  # block exhausted by hits: next block
                    continue
            if i >= n:
                break
            # The breaker is a genuine miss: either its location is invalid
            # (not resident / not prefetched) or its in-run predecessor was
            # just consumed, which empties the location either way.
            f, data = self.access(r, lo + i, int(fids[i]), io_by_node)
            out[i] = f
            if payloads is not None:
                payloads.append(data)
            i += 1
        self.positions[r] = hi
        return out

    # -------------------------------------------------------------- drivers
    def _step_bounds(self, r: int, batch_per_node: int) -> tuple[int, int]:
        """Node ``r``'s next step slice: ``batch_per_node`` accesses from its
        cursor. For a static cluster this is exactly the old fixed
        ``[step*b, (step+1)*b)`` grid; cursors are what let a freshly joined
        node start at 0 mid-epoch and a restored cluster resume mid-grid."""
        lo = int(self.positions[r])
        return lo, min(lo + batch_per_node, int(self.sequences[r].size))

    def _live_exhausted(self) -> bool:
        return all(
            self.positions[r] >= self.sequences[r].size
            for r in range(self.num_nodes)
            if not self.failed[r]
        )

    def epoch_stream(
        self,
        sampler: "EpochSampler | None",
        epoch: int,
        batch_per_node: int,
        *,
        stepping: str = "ceil",
        engine: str = "step",
        collect_payloads: bool = False,
        recorder=None,
        failures: "dict[int, int] | None" = None,
        joins: "dict[int, int] | None" = None,
        start_step: int = 0,
        resume: bool = False,
    ):
        """THE epoch driver: every live epoch walk goes through here.

        Yields ``(step, returned_per_node, payloads, io_by_node)`` per
        training step. ``stepping`` controls the step grid:

        * ``"ceil"`` — ``max_r ceil(len_r / b)`` steps, ragged last step
          included in the grid (the :meth:`run_epoch` accounting used by the
          time model);
        * ``"floor_tail"`` — ``min_r len_r // b`` full-size steps are
          yielded; the ragged remainder is drained afterwards *without*
          yielding (the loader contract: fixed-shape batches only).

        ``engine`` selects the batched id-space walk (``"step"``) or the
        reference per-access walk (``"per_access"``) — kept for planner
        equivalence tests and as the benchmark baseline.

        Elastic events, both applied at step barriers and in this order:
        ``failures`` maps a step index to a node id to kill
        (:meth:`fail_node`); ``joins`` maps a step index to a count of fresh
        nodes to admit (:meth:`join_node`). Step keys are absolute, so the
        same schedules drive a resumed suffix unchanged.

        Resume (DESIGN.md §10): with ``resume=True`` the cluster's mid-epoch
        state — installed by :meth:`Cluster.restore` — is used as-is (no
        ``begin_epoch``; ``sampler`` may be None) and the walk continues
        from ``start_step``. The recorder, when given, sees steps relative
        to the stream's own start (a resumed recorder builds a *suffix*
        plan); the yielded step indices stay absolute.
        """
        assert stepping in ("ceil", "floor_tail")
        assert engine in ("step", "per_access")
        if resume:
            assert self.sequences is not None, "resume without restored state"
        else:
            assert start_step == 0
            self.begin_epoch(sampler, epoch)
        self._grid = (batch_per_node, stepping)
        self.current_step = start_step
        self._vectorized = engine == "step"
        if recorder is not None:
            self.set_recorder(recorder)
        try:
            if stepping == "floor_tail":
                assert not failures and not joins, (
                    "elastic-event schedules require ceil stepping"
                )
                num_steps = min(s.size for s in self.sequences) // batch_per_node
            step = start_step
            while True:
                if stepping == "ceil":
                    if failures and step in failures:
                        dead = failures[step]
                        self.fail_node(dead, int(self.positions[dead]))
                    if joins and step in joins:
                        for _ in range(joins[step]):
                            self.join_node()
                    if self._live_exhausted():
                        break
                elif step >= num_steps:
                    break
                tracer = trace.get()
                t0 = time.perf_counter() if tracer is not None else 0.0
                io_by_node: dict[int, StepIO] = {}
                if recorder is not None:
                    recorder.begin_step(step - start_step)
                returned: list[np.ndarray] = []
                payloads: "list | None" = [] if collect_payloads else None
                for r in range(self.num_nodes):
                    if self.failed[r]:
                        returned.append(np.empty(0, dtype=np.int64))
                        continue
                    lo, hi = self._step_bounds(r, batch_per_node)
                    if engine == "step":
                        ret = self.access_step(r, lo, hi, io_by_node, payloads=payloads)
                    else:
                        ret = np.empty(hi - lo, dtype=np.int64)
                        for pos in range(lo, hi):
                            f, data = self.access(
                                r, pos, int(self.sequences[r][pos]), io_by_node
                            )
                            ret[pos - lo] = f
                            if payloads is not None:
                                payloads.append(data)
                    returned.append(ret)
                if recorder is not None:
                    recorder.end_step(step - start_step, returned, io_by_node)
                self.current_step = step + 1
                if tracer is not None:
                    # Spans cover production only — consumer time between
                    # yields must not pollute the proto stage.
                    tracer.complete(
                        "proto.step", "proto", t0,
                        time.perf_counter() - t0, {"step": step},
                    )
                yield step, returned, payloads, io_by_node
                step += 1
            if stepping == "floor_tail":
                # Drain the ragged tail so exactly-once epoch invariants hold.
                io_by_node = {}
                if recorder is not None:
                    recorder.begin_step(num_steps - start_step)
                tail: list[np.ndarray] = []
                for r in range(self.num_nodes):
                    lo = int(self.positions[r])
                    # payloads popped but not collected: tail records are
                    # consumed for the invariants, never trained on
                    tail.append(
                        self.access_step(r, lo, self.sequences[r].size, io_by_node)
                    )
                if recorder is not None:
                    recorder.end_step(num_steps - start_step, tail, io_by_node)
            self._check_epoch_complete()
        finally:
            self._vectorized = True
            if recorder is not None:
                self.set_recorder(None)

    def run_epoch(
        self,
        sampler: EpochSampler,
        epoch: int,
        batch_per_node: int,
        *,
        collect_returned: bool = True,
        engine: str = "step",
        plan=None,
        recorder=None,
        failures: "dict[int, int] | None" = None,
        joins: "dict[int, int] | None" = None,
    ) -> EpochResult:
        """Execute a full epoch with per-step node interleaving (DP barrier).

        With ``plan`` (an :class:`repro.core.planner.EpochPlan`) the epoch is
        *replayed* from the pre-computed schedule instead of executed live —
        no protocol decisions, no RNG, just the recorded event stream.
        """
        empty = np.empty(0, dtype=np.int64)
        per_node_step_io: list[list[StepIO]] = [[] for _ in range(self.num_nodes)]
        returned: list[list[np.ndarray]] = [[] for _ in range(self.num_nodes)]
        steps_seen = 0
        if plan is not None:
            stream = self.replay_stream(
                plan, epoch=epoch, batch_per_node=batch_per_node, stepping="ceil"
            )
        else:
            stream = self.epoch_stream(
                sampler, epoch, batch_per_node,
                engine=engine, recorder=recorder, failures=failures, joins=joins,
            )
        for _, step_returned, _, io_by_node in stream:
            while len(per_node_step_io) < self.num_nodes:
                # A node joined mid-epoch: backfill its pre-join steps so the
                # StepIO/returned grids stay rectangular (and identical to a
                # replayed plan's padded grid).
                per_node_step_io.append([StepIO() for _ in range(steps_seen)])
                returned.append([empty] * steps_seen)
            for r in range(self.num_nodes):
                per_node_step_io[r].append(io_by_node.get(r, StepIO()))
                if collect_returned:
                    returned[r].append(
                        step_returned[r] if r < len(step_returned) else empty
                    )
            steps_seen += 1
        node_stats = [n.stats for n in self.nodes]
        agg = node_stats[0]
        for s in node_stats[1:]:
            agg = agg.merge(s)
        return EpochResult(
            stats=agg,
            node_stats=node_stats,
            per_node_step_io=per_node_step_io,
            returned=[
                np.concatenate(rt) if rt else empty for rt in returned
            ],
        )

    def replay_stream(
        self,
        plan,
        *,
        epoch: int | None = None,
        batch_per_node: int | None = None,
        stepping: str | None = None,
        collect_payloads=None,
    ):
        """Replay a pre-computed :class:`EpochPlan`: the execute half of the
        plan/execute split.

        Yields the same ``(step, returned_per_node, payloads, io_by_node)``
        stream as :meth:`epoch_stream` without running any protocol logic.
        In real-bytes mode (a ChunkStore attached) the plan's exact chunk
        schedule is handed to the storage backend up front
        (:meth:`ChunkStore.schedule_reads`), so readahead is clairvoyant
        rather than heuristic; reads/ships/returns then follow the recorded
        event order. Node stats are installed from the plan (they are exact
        protocol counters) with measured read-wait folded in.
        """
        store = self.store
        if collect_payloads is None:
            collect_payloads = store is not None
        if plan.joined_nodes and self.num_nodes == plan.num_nodes - plan.joined_nodes:
            # The plan admitted nodes mid-epoch; replay needs matching shells
            # (no protocol state — the recorded events carry everything).
            while self.num_nodes < plan.num_nodes:
                self._append_node()
        plan.validate(self, epoch, batch_per_node, stepping)
        for r, st in enumerate(plan.node_stats):
            self.nodes[r].stats = st.copy()
        if store is not None:
            store.schedule_reads(plan.load_chunk.tolist())
        # One global payload pool: exactly-once guarantees each file is
        # loaded at most once and consumed exactly once per epoch, so
        # ownership transfers (ships, remote on-demand responses) never need
        # modelling here — the byte movement they represent is priced by the
        # plan's StepIO net counters, not re-enacted.
        pool: dict[int, bytes] = {}
        if plan.start_step and store is not None:
            # Resumed suffix: files already resident/prefetched at the
            # snapshot have no load event in the suffix plan — their bytes
            # were rehydrated into the restored cluster by Cluster.restore.
            for node in self.nodes:
                pool.update(node.buffer)
            for rm in self.remote_mem:
                for loc, data in rm._payloads.items():
                    pool[int(rm._loc_file[loc])] = data
        for step in range(plan.num_steps + (1 if plan.has_tail else 0)):
            tracer = trace.get()
            t0 = time.perf_counter() if tracer is not None else 0.0
            io_by_node = plan.step_io(step)
            if store is not None:
                for li in range(*plan.load_range(step)):
                    owner = int(plan.load_owner[li])
                    t0 = time.perf_counter()
                    records = dict(store.read_chunk(int(plan.load_chunk[li])))
                    wait = time.perf_counter() - t0
                    st = self.nodes[owner].stats
                    st.read_wait_s += wait
                    if owner in io_by_node:
                        io_by_node[owner].read_wait_s += wait
                    st.peak_inflight_reads = max(
                        st.peak_inflight_reads, store.backend_stats.peak_inflight
                    )
                    for f in plan.load_files(li).tolist():
                        pool[f] = records[f]
            returned = plan.step_returned(step)
            if step >= plan.num_steps:
                if store is not None:  # tail payloads are read but never yielded
                    for ret in returned:
                        for f in ret.tolist():
                            pool.pop(f, None)
                break
            payloads = None
            if collect_payloads:
                payloads = [
                    pool.pop(int(f)) for ret in returned for f in ret.tolist()
                ]
            if tracer is not None:
                tracer.complete(
                    "replay.step", "proto", t0, time.perf_counter() - t0,
                    {"step": plan.start_step + step},
                )
            # Suffix plans (EpochPlanner.plan_from) are step-indexed from
            # their resume point; yield absolute step numbers either way.
            yield plan.start_step + step, returned, payloads, io_by_node
        assert not pool, "replay left undelivered payloads behind"

    def _check_epoch_complete(self) -> None:
        """Every file consumed at its (current) owner; all memories drained.

        Exactly-once of the *returned stream* is asserted separately by the
        property tests (counting each file in ``EpochResult.returned``) —
        here we check the owner-side bookkeeping, which must hold even after
        an elastic ownership remap.
        """
        for r in range(self.num_nodes):
            if self.failed[r]:
                continue
            assert self.nodes[r].memory.is_empty(), "local abstract memory not drained"
            assert len(self.remote_mem[r]) == 0, "remote abstract memory not drained"
        owner_of_file = self.owner_of_group[
            self.plan.group_of_chunk[self.plan.chunk_of]
        ]
        for r in range(self.num_nodes):
            if self.failed[r]:
                continue
            mask = owner_of_file == r
            assert self.nodes[r].consumed[mask].all(), (
                "a file was never consumed (exactly-once violated)"
            )

    # ------------------------------------------------------- fault tolerance
    def fail_node(self, dead: int, processed_upto: int) -> None:
        """Node ``dead`` fails after completing ``processed_upto`` accesses.

        Its unprocessed sequence tail is redistributed round-robin and
        *appended* to the survivors' sequences — appending keeps every
        existing position stable, so outstanding prefetch bookkeeping
        (keyed by position) remains exact; only the location index is
        rebuilt. Ownership is then remapped (see :meth:`remap_ownership`).
        """
        assert self.sequences is not None, "fail_node outside an epoch"
        tail = self.sequences[dead][processed_upto:]
        self.sequences[dead] = self.sequences[dead][:processed_upto]
        self.positions[dead] = processed_upto
        self.remap_ownership(dead)
        survivors = [r for r in range(self.num_nodes) if not self.failed[r]]
        shares = [tail[i :: len(survivors)] for i in range(len(survivors))]
        for r, share in zip(survivors, shares):
            self.sequences[r] = np.concatenate([self.sequences[r], share])
        # Rebuild the per-node sequence indexes (positions in the unchanged
        # prefixes are preserved, so pending[o][r] entries stay valid).
        self._index_sequences()

    def remap_ownership(self, dead: int) -> None:
        """Elastic remap after node ``dead`` fails mid-epoch (DESIGN.md §5).

        Durable state (disk chunks — replicated/NAS-resident in the paper's
        setups — and the consumption journal) survives; volatile state (the
        node's abstract-memory residents and its un-consumed prefetches held
        *for* it) is re-fetchable from disk precisely because never-evicted
        residents are by definition un-consumed.
        """
        assert not self.failed[dead]
        self.failed[dead] = True
        survivors = [r for r in range(self.num_nodes) if not self.failed[r]]
        assert survivors, "no survivors"
        # 1. Reassign the dead node's groups round-robin to survivors.
        dead_groups = np.nonzero(self.owner_of_group == dead)[0]
        for i, grp in enumerate(dead_groups):
            self.owner_of_group[grp] = survivors[i % len(survivors)]
        # 2. Its residents are lost with its memory: un-consume nothing (they
        #    were never consumed) and clear the slots so the new owner's
        #    refills can re-fetch the files from the replicated store.
        mem = self.nodes[dead].memory
        live = np.nonzero(mem.resident.reshape(-1) >= 0)[0]
        for flat in live:
            g, s = divmod(int(flat), self.plan.chunk_size)
            mem.take(g, s)
        # 3. Migrate the consumption journal to the new owners. Our in-process
        #    LocalNodes each hold a full-size consumed bitmap, so survivors
        #    merge the dead node's journal directly.
        journal = self.nodes[dead].consumed
        for r in survivors:
            self.nodes[r].consumed |= journal
        # 4. Outstanding prefetches *from* the dead node already live in the
        #    requesters' remote memories (real data — still valid). Their
        #    check-list entries migrate to the groups' new owners so nobody
        #    double-ships to a still-occupied location.
        for r in range(self.num_nodes):
            for loc in np.nonzero(self.pending[dead][r])[0].tolist():
                new_o = int(self.owner_of_group[loc // self.plan.chunk_size])
                self.pending[new_o][r][loc] = True
                self.pending_sent[new_o][r][loc] = self.pending_sent[dead][r][loc]
            self.pending[dead][r][:] = False
        # 5. Prefetched files sitting in the dead node's *remote memory* were
        #    journalled as consumed by their senders but never reached
        #    training. Requesters durably journal remote consumptions too (4
        #    bytes/file, same as the owner journal), so on recovery the
        #    senders un-consume exactly the lost ones; survivors will then
        #    re-fetch them from the chunk store through normal refills.
        rm_dead = self.remote_mem[dead]
        for loc in rm_dead.locations().tolist():
            f, _ = rm_dead.take(loc)
            for r in survivors:
                self.nodes[r].consumed[f] = False
        for o in range(self.num_nodes):
            self.pending[o][dead][:] = False
        # 6. Repatriation: a survivor may now *own* a location for which it
        #    holds a prefetched file in its remote memory (the prefetch came
        #    from the dead ex-owner). The owner path never consults remote
        #    memory, so convert such entries back into ordinary residents of
        #    the new owner's local abstract memory (un-consuming them — a
        #    resident is by definition un-consumed).
        c = self.plan.chunk_size
        for r in survivors:
            rm_r = self.remote_mem[r]
            self_locs = [
                loc for loc in rm_r.locations().tolist()
                if int(self.owner_of_group[loc // c]) == r
            ]
            for loc in self_locs:
                f, data = rm_r.take(loc)
                for r2 in survivors:
                    self.nodes[r2].consumed[f] = False
                gq, sq = divmod(loc, c)
                self.nodes[r].memory.fill(gq, sq, f)
                if data is not None:
                    self.nodes[r].buffer[f] = data
                self.pending[r][r][loc] = False

    # --------------------------------------------------------- elastic join
    def _append_node(self) -> int:
        """Structural growth: append a fresh node shell (LocalNode, remote
        memory, check-list row + column, cursor). Shared by
        :meth:`join_node` (which rebalances state onto the shell) and by
        replay of plans containing joins (replay never runs the protocol,
        so the shell needs no protocol state)."""
        new = self.num_nodes
        self.num_nodes = new + 1
        node = LocalNode(
            self.plan,
            policy=self.policy,
            seed=(self.seed, 7, new),
            store=self.store,
            node_id=new,
        )
        node.recorder = self._recorder
        self.nodes.append(node)
        self.remote_mem.append(
            RemoteMemory(self._remote_limit, self.plan.file_sizes, self.plan.num_slots)
        )
        m = self.plan.num_slots
        for row, srow in zip(self.pending, self.pending_sent):
            row.append(np.zeros(m, dtype=bool))
            srow.append(np.zeros(m, dtype=np.int64))
        self.pending.append(
            [np.zeros(m, dtype=bool) for _ in range(self.num_nodes)]
        )
        self.pending_sent.append(
            [np.zeros(m, dtype=np.int64) for _ in range(self.num_nodes)]
        )
        self.failed = np.append(self.failed, False)
        self.positions = np.append(self.positions, 0)
        return new

    def join_node(self) -> int:
        """Admit a fresh node mid-epoch: the elastic dual of :meth:`fail_node`.

        The same position-stability trick applies, mirrored: every existing
        node keeps a *prefix* of its sequence (all served positions and the
        outstanding-prefetch bookkeeping keyed by them stay valid) and only
        donates a suffix of unconsumed tail accesses, which become the new
        node's sequence. Ownership rebalances by moving whole chunk groups
        — their abstract-memory residents (and payload bytes) and their
        check-list entries migrate with the group (owner-side moves only:
        requester positions and ``pending_sent`` stay untouched), so
        exactly-once is preserved without touching disk. A donated access
        whose prefetched file sits in the donor's remote memory is handled
        like a failed node's remote memory (DESIGN.md §5/§10): the sender
        un-consumes it and the file re-enters through a normal refill.

        Deterministic given (cluster state, epoch): the planner's shadow
        walk of a ``joins`` schedule reproduces the live decisions exactly.
        """
        assert self.sequences is not None, "join_node outside an epoch"
        prev_live = [r for r in range(self.num_nodes) if not self.failed[r]]
        new = self._append_node()
        node = self.nodes[new]
        if self.epoch is not None:
            # Same per-epoch RNG derivation as LocalNode.begin_epoch: the
            # joined node's refill stream is a pure function of
            # (seed, node_id, epoch), independent of join time.
            seed = node.seed if isinstance(node.seed, tuple) else (node.seed,)
            node.rng = np.random.default_rng((*seed, self.epoch))
        # 1. Journal replication: the union of the live nodes' journals is
        #    exactly the set of files truly consumed so far (see
        #    remap_ownership step 3 — merges keep every live copy accurate).
        for r in prev_live:
            node.consumed |= self.nodes[r].consumed
        live = prev_live + [new]
        # 2. Ownership rebalance: move whole groups from the largest owners
        #    until the new node holds a fair share.
        counts = {r: int((self.owner_of_group == r).sum()) for r in prev_live}
        target = self.plan.num_groups // len(live)
        moved = 0
        while moved < target:
            donor = max(prev_live, key=lambda r: (counts[r], -r))
            if counts[donor] <= 1:
                break  # never strip an owner bare
            g = int(np.nonzero(self.owner_of_group == donor)[0][-1])
            self._move_group(g, donor, new)
            counts[donor] -= 1
            moved += 1
        # 3. Sequence rebalance: each live node donates the last
        #    ``remaining // len(live)`` of its unconsumed tail.
        tails: list[np.ndarray] = []
        for r in prev_live:
            size = int(self.sequences[r].size)
            pos = int(self.positions[r])
            move = (size - pos) // len(live)
            if move <= 0:
                continue
            cut = size - move
            self._release_moved_prefetches(r, pos, cut)
            tails.append(self.sequences[r][cut:])
            self.sequences[r] = self.sequences[r][:cut]
        self.sequences.append(
            np.concatenate(tails) if tails else np.empty(0, dtype=np.int64)
        )
        self._index_sequences()
        return new

    def _move_group(self, g: int, old: int, new: int) -> None:
        """Move chunk-group ``g`` (ownership, residents + payloads, and the
        outstanding check-list entries for its locations) between nodes."""
        c = self.plan.chunk_size
        self.owner_of_group[g] = new
        old_node, new_node = self.nodes[old], self.nodes[new]
        slots = np.nonzero(old_node.memory.resident[g] >= 0)[0]
        if slots.size:
            files = old_node.memory.resident[g][slots].copy()
            old_node.memory.take_many(np.full(slots.size, g, dtype=np.int64), slots)
            new_node.memory.fill_many(g, slots, files)
            if old_node.store is not None:
                for f in files.tolist():
                    new_node.buffer[f] = old_node.buffer.pop(f)
        lo, hi = g * c, (g + 1) * c
        for r in range(self.num_nodes):
            mask = self.pending[old][r][lo:hi]
            if mask.any():
                idx = np.nonzero(mask)[0] + lo
                self.pending[new][r][idx] = True
                self.pending_sent[new][r][idx] = self.pending_sent[old][r][idx]
                self.pending[old][r][lo:hi] = False

    def _release_moved_prefetches(self, r: int, pos: int, cut: int) -> None:
        """Node ``r`` donates sequence positions ``[cut, end)``. Any file in
        its remote memory whose consuming access (the next access of its
        location) falls in the donated suffix is released: the sender
        un-consumes it everywhere (requesters journal remote consumptions
        durably, exactly like the fail_node recovery path) and its
        check-list entry is dropped, so the file re-enters via a refill and
        is eventually consumed at the donated access's new home."""
        rm_r = self.remote_mem[r]
        held = rm_r.locations()
        if held.size == 0:
            return
        kept_window = self._loc_of_seq[r][pos:cut]
        live = [x for x in range(self.num_nodes) if not self.failed[x]]
        for loc in held.tolist():
            if (kept_window == loc).any():
                continue  # still consumed by one of r's kept positions
            f, _ = rm_r.take(loc)
            for o in range(self.num_nodes):
                self.pending[o][r][loc] = False
            for r2 in live:
                self.nodes[r2].consumed[f] = False

    # ----------------------------------------------------- snapshot/restore
    def snapshot(self, *, step: "int | None" = None):
        """Capture the full mid-epoch protocol state (see core/elastic.py).

        ``step`` overrides the driver-maintained next-step index (manual
        access-level drivers pass their own grid position)."""
        from .elastic import ClusterSnapshot

        return ClusterSnapshot.capture(self, step=step)

    @staticmethod
    def restore(snap, *, plan: "ChunkingPlan | None" = None, store=None) -> "Cluster":
        """Rebuild a mid-epoch cluster — in a fresh process — from a
        :class:`repro.core.elastic.ClusterSnapshot`.

        The plan comes from ``store`` when one is attached (real-bytes
        resume; payloads of resident/prefetched files are re-read from it),
        else must be passed explicitly (id-space resume)."""
        if plan is None:
            if store is None:
                raise ValueError("restore() needs a ChunkingPlan or a ChunkStore")
            plan = store.plan
        snap.check_plan(plan)
        cfg = snap.config
        cluster = Cluster(
            plan,
            int(cfg["num_nodes"]),
            remote_memory_limit_bytes=int(cfg["remote_memory_limit_bytes"]),
            prefetch_window=int(cfg["prefetch_window"]),
            policy=cfg["policy"],
            prefetch=bool(cfg["prefetch"]),
            seed=cfg["seed"],
            store=store,
        )
        snap.install(cluster)
        return cluster
