"""Elastic data plane: snapshot/restore of mid-epoch protocol state (DESIGN.md §10).

The Redox protocol keeps *all* of its state explicit — per-node access
sequences and positions, abstract-memory residency, the consumption
journal, the prefetch check lists, and the refill RNG streams — which is
what makes the mid-epoch state machine checkpointable: a
:class:`ClusterSnapshot` captures every one of those arrays, round-trips
through an ``.npz`` + JSON-manifest pair (the same format family as
``repro.checkpoint``), and a **fresh process** can rebuild the cluster and
continue the epoch with a byte-identical stream (``tests/elastic_harness.py``
proves it differentially).

Payload bytes are deliberately *not* part of the snapshot: a resident file
is by definition un-consumed, so its chunk is still on disk — restore
re-reads exactly the chunks backing resident/prefetched files
(:func:`ClusterSnapshot.install` rehydration). This is the same durability
argument that makes ``Cluster.fail_node`` sound (never-evicted residents
are re-fetchable), applied to suspend/resume.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import uuid
from pathlib import Path

import numpy as np

from .stats import NodeStats

__all__ = ["ClusterSnapshot"]

STATE_FILE = "data_state.npz"
MANIFEST_FILE = "data_manifest.json"


@dataclasses.dataclass
class ClusterSnapshot:
    """Full mid-epoch protocol state of one :class:`repro.core.Cluster`.

    The state inventory (one entry per protocol subsystem):

    * ``sequences``/``positions`` — per-node access sequences (as rebalanced
      by any ``fail_node``/``join_node`` so far) and the per-node cursor of
      accesses already served;
    * ``resident``/``mem_peak`` — every node's abstract-memory slot table;
    * ``consumed`` — the per-node consumption journals (exactly-once);
    * ``remote_loc``/``remote_peak`` — requester-side prefetched files;
    * ``pending``/``pending_sent`` — the outstanding-prefetch check lists;
    * ``rng_states`` — each node's refill RNG, mid-stream;
    * ``node_stats`` — exact protocol counters so the resumed epoch's
      end-of-epoch NodeStats equal the uninterrupted run's;
    * ``owner_of_group``/``failed`` — the elastic ownership map.
    """

    config: dict                # Cluster constructor configuration
    plan_fp: dict               # ChunkingPlan fingerprint (restore validation)
    epoch: int
    step: int                   # next step index of the epoch driver
    grid: dict                  # {"batch_per_node": int|None, "stepping": str|None}
    owner_of_group: np.ndarray  # int32[G]
    failed: np.ndarray          # bool[N]
    positions: np.ndarray       # int64[N] accesses served per node
    sequences: list             # list[int64[...]] per node
    resident: np.ndarray        # int64[N, G, c] abstract-memory slot tables
    mem_peak: np.ndarray        # int64[N]
    consumed: np.ndarray        # bool[N, num_files]
    remote_loc: np.ndarray      # int64[N, M] remote-memory location tables
    remote_peak: np.ndarray     # int64[N]
    pending: np.ndarray         # bool[N, N, M] prefetch check lists
    pending_sent: np.ndarray    # int64[N, N, M]
    rng_states: list            # list[dict] PCG64 states (json-able)
    node_stats: list            # list[NodeStats]

    # ------------------------------------------------------------- capture
    @staticmethod
    def capture(cluster, *, step: "int | None" = None) -> "ClusterSnapshot":
        """Copy every piece of mid-epoch state out of ``cluster``.

        ``step`` is the next step index the epoch driver would execute
        (defaults to the driver-maintained ``cluster.current_step``); manual
        access-level drivers pass their own.
        """
        assert cluster.sequences is not None, "snapshot outside an epoch"
        plan = cluster.plan
        n = cluster.num_nodes
        batch, stepping = cluster._grid
        return ClusterSnapshot(
            config=dict(
                num_nodes=n,
                policy=cluster.policy,
                prefetch=bool(cluster.prefetch),
                prefetch_window=int(cluster.prefetch_window),
                seed=cluster.seed,
                remote_memory_limit_bytes=int(cluster._remote_limit),
            ),
            plan_fp=dict(
                num_files=plan.num_files,
                chunk_size=plan.chunk_size,
                num_chunks=plan.num_chunks,
                num_groups=plan.num_groups,
                seed=plan.seed,
            ),
            epoch=int(cluster.epoch),
            step=int(cluster.current_step if step is None else step),
            grid={"batch_per_node": batch, "stepping": stepping},
            owner_of_group=cluster.owner_of_group.copy(),
            failed=cluster.failed.copy(),
            positions=np.asarray(cluster.positions, dtype=np.int64).copy(),
            sequences=[s.copy() for s in cluster.sequences],
            resident=np.stack([nd.memory.resident for nd in cluster.nodes]).copy(),
            mem_peak=np.array(
                [nd.memory.peak_bytes for nd in cluster.nodes], dtype=np.int64
            ),
            consumed=np.stack([nd.consumed for nd in cluster.nodes]).copy(),
            remote_loc=np.stack(
                [rm._loc_file for rm in cluster.remote_mem]
            ).copy(),
            remote_peak=np.array(
                [rm.peak_bytes for rm in cluster.remote_mem], dtype=np.int64
            ),
            pending=np.stack(
                [np.stack(row) for row in cluster.pending]
            ).copy(),
            pending_sent=np.stack(
                [np.stack(row) for row in cluster.pending_sent]
            ).copy(),
            rng_states=[
                copy.deepcopy(nd.rng.bit_generator.state) for nd in cluster.nodes
            ],
            node_stats=[nd.stats.copy() for nd in cluster.nodes],
        )

    # ------------------------------------------------------------- install
    def install(self, cluster, *, rehydrate: bool = True) -> None:
        """Write this snapshot's state into a freshly constructed cluster.

        ``cluster`` must have been built with this snapshot's configuration
        (``Cluster.restore`` does both halves). With a ChunkStore attached
        and ``rehydrate=True``, payload bytes for resident and prefetched
        files are re-read from storage — exactly one ``read_chunk`` per
        chunk backing live state.
        """
        plan = cluster.plan
        cluster.owner_of_group[:] = self.owner_of_group
        cluster.failed[:] = self.failed
        cluster.positions = self.positions.copy()
        cluster.sequences = [s.copy() for s in self.sequences]
        for r, node in enumerate(cluster.nodes):
            mem = node.memory
            mem.resident[:] = self.resident[r]
            live = mem.resident_flat[mem.resident_flat >= 0]
            mem.used_bytes = int(plan.file_sizes[live].sum())
            mem.resident_count = int(live.size)
            mem.peak_bytes = int(self.mem_peak[r])
            node.consumed[:] = self.consumed[r]
            node.rng.bit_generator.state = copy.deepcopy(self.rng_states[r])
            node.stats = self.node_stats[r].copy()
            rm = cluster.remote_mem[r]
            rm._loc_file[:] = self.remote_loc[r]
            held = rm._loc_file[rm._loc_file >= 0]
            rm._count = int(held.size)
            rm.used_bytes = int(plan.file_sizes[held].sum())
            rm.peak_bytes = int(self.remote_peak[r])
        for o in range(cluster.num_nodes):
            for r in range(cluster.num_nodes):
                cluster.pending[o][r][:] = self.pending[o, r]
                cluster.pending_sent[o][r][:] = self.pending_sent[o, r]
        cluster.epoch = int(self.epoch)
        cluster.current_step = int(self.step)
        cluster._grid = (self.grid.get("batch_per_node"), self.grid.get("stepping"))
        cluster._index_sequences()
        if rehydrate and cluster.store is not None:
            self._rehydrate_payloads(cluster)

    def _rehydrate_payloads(self, cluster) -> None:
        """Re-read the chunks backing resident/prefetched files (real-bytes
        mode): un-consumed state is by definition still on disk."""
        plan = cluster.plan
        # file -> ("local", node) or ("remote", node, loc)
        wanted: "dict[int, tuple]" = {}
        for r, node in enumerate(cluster.nodes):
            for f in node.memory.resident_flat[
                node.memory.resident_flat >= 0
            ].tolist():
                wanted[int(f)] = ("local", r)
            rm = cluster.remote_mem[r]
            for loc in rm.locations().tolist():
                wanted[int(rm._loc_file[loc])] = ("remote", r, int(loc))
        if not wanted:
            return
        chunks = np.unique(plan.chunk_of[np.fromiter(wanted, dtype=np.int64)])
        for k in chunks.tolist():
            records = dict(cluster.store.read_chunk(int(k)))
            for f in plan.files_in_chunk(int(k)).tolist():
                where = wanted.get(int(f))
                if where is None:
                    continue
                if where[0] == "local":
                    cluster.nodes[where[1]].buffer[int(f)] = records[int(f)]
                else:
                    cluster.remote_mem[where[1]].store_payload(
                        where[2], records[int(f)]
                    )

    # --------------------------------------------------------- persistence
    def save(self, out_dir: "str | Path") -> Path:
        """Write ``data_state.npz`` + ``data_manifest.json`` under ``out_dir``.

        Both files are written to temp names and atomically replaced, and
        both carry a shared per-save token: a crash between the two
        replaces (the launchers overwrite the same directory at every
        checkpoint) leaves a *torn* pair that :meth:`load` rejects with a
        clear error instead of resuming from mixed state.
        """
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        token = uuid.uuid4().hex
        seq_offs = np.zeros(len(self.sequences) + 1, dtype=np.int64)
        np.cumsum([s.size for s in self.sequences], out=seq_offs[1:])
        seq_flat = (
            np.concatenate(self.sequences)
            if self.sequences else np.empty(0, np.int64)
        )
        tmp_state = out_dir / (".tmp_" + STATE_FILE)
        tmp_manifest = out_dir / (".tmp_" + MANIFEST_FILE)
        try:
            np.savez_compressed(
                tmp_state,
                token=np.array(token),
                seq_flat=seq_flat,
                seq_offs=seq_offs,
                owner_of_group=self.owner_of_group,
                failed=self.failed,
                positions=self.positions,
                resident=self.resident,
                mem_peak=self.mem_peak,
                consumed=self.consumed,
                remote_loc=self.remote_loc,
                remote_peak=self.remote_peak,
                pending=self.pending,
                pending_sent=self.pending_sent,
            )
            manifest = dict(
                token=token,
                config=self.config,
                plan_fp=self.plan_fp,
                epoch=self.epoch,
                step=self.step,
                grid=self.grid,
                rng_states=self.rng_states,
                node_stats=[dataclasses.asdict(s) for s in self.node_stats],
            )
            tmp_manifest.write_text(json.dumps(manifest))
            tmp_state.replace(out_dir / STATE_FILE)
            tmp_manifest.replace(out_dir / MANIFEST_FILE)
        except BaseException:
            tmp_state.unlink(missing_ok=True)
            tmp_manifest.unlink(missing_ok=True)
            raise
        return out_dir

    @staticmethod
    def load(in_dir: "str | Path") -> "ClusterSnapshot":
        in_dir = Path(in_dir)
        manifest = json.loads((in_dir / MANIFEST_FILE).read_text())
        with np.load(in_dir / STATE_FILE, allow_pickle=False) as z:
            if str(z["token"]) != manifest["token"]:
                raise ValueError(
                    f"torn snapshot in {in_dir}: {STATE_FILE} and "
                    f"{MANIFEST_FILE} come from different save() calls "
                    "(crash mid-overwrite?) — restore from an older "
                    "checkpoint"
                )
            seq_offs = z["seq_offs"]
            seq_flat = z["seq_flat"]
            sequences = [
                seq_flat[seq_offs[i] : seq_offs[i + 1]].copy()
                for i in range(seq_offs.size - 1)
            ]
            return ClusterSnapshot(
                config=manifest["config"],
                plan_fp=manifest["plan_fp"],
                epoch=int(manifest["epoch"]),
                step=int(manifest["step"]),
                grid=manifest["grid"],
                owner_of_group=z["owner_of_group"].copy(),
                failed=z["failed"].copy(),
                positions=z["positions"].copy(),
                sequences=sequences,
                resident=z["resident"].copy(),
                mem_peak=z["mem_peak"].copy(),
                consumed=z["consumed"].copy(),
                remote_loc=z["remote_loc"].copy(),
                remote_peak=z["remote_peak"].copy(),
                pending=z["pending"].copy(),
                pending_sent=z["pending_sent"].copy(),
                rng_states=manifest["rng_states"],
                node_stats=[
                    NodeStats(**d) for d in manifest["node_stats"]
                ],
            )

    # ----------------------------------------------------------- validation
    def check_plan(self, plan) -> None:
        fp = dict(
            num_files=plan.num_files,
            chunk_size=plan.chunk_size,
            num_chunks=plan.num_chunks,
            num_groups=plan.num_groups,
            seed=plan.seed,
        )
        if fp != self.plan_fp:
            raise ValueError(
                f"snapshot was taken against a different ChunkingPlan: "
                f"{self.plan_fp} != {fp}"
            )
