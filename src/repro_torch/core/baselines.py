"""The paper's three baselines, protocol-exact (paper §5.1 "Baselines").

* :class:`PyTorchStyleLoader` — per-file random reads in sequence order,
  memory managed by an OS-page-cache-like byte-capacity LRU. Under a
  uniformly random exactly-once sequence with dataset ≫ memory the LRU hit
  rate collapses toward ``memory/dataset`` — the paper's §2.1 observation.
* :class:`CoorDLLoader` — MinIO-style fixed cache [Mohan et al., VLDB'21]:
  a static fraction of files is pinned in memory, never evicted; in the
  distributed setting a file cached on a *peer* is fetched over the network
  instead of from disk. No randomness sacrificed; hit rate bounded by the
  global memory/dataset ratio.
* :class:`NoIOLoader` — zero-I/O upper bound (data synthesised on the fly).

All loaders consume the *same* access sequences, report the same
:class:`~repro.core.stats.StepIO` demand units, and are priced by the same
:class:`~repro.core.stats.PipelineTimeModel`, so speedups are apples to
apples.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from .chunking import ChunkingPlan
from .sampler import EpochSampler
from .stats import NodeStats, StepIO

__all__ = ["PyTorchStyleLoader", "CoorDLLoader", "NoIOLoader", "run_baseline_epoch"]


class _LRUBytes:
    """Byte-capacity LRU of file ids (page-cache stand-in)."""

    def __init__(self, capacity: int, sizes: np.ndarray):
        self.capacity = int(capacity)
        self._sizes = sizes
        self._cache: OrderedDict[int, int] = OrderedDict()
        self.used = 0

    def hit(self, f: int) -> bool:
        if f in self._cache:
            self._cache.move_to_end(f)
            return True
        return False

    def admit(self, f: int) -> None:
        size = int(self._sizes[f])
        if size > self.capacity:
            return
        while self.used + size > self.capacity and self._cache:
            _, old = self._cache.popitem(last=False)
            self.used -= old
        self._cache[f] = size
        self.used += size


class PyTorchStyleLoader:
    """Native-DataLoader baseline: one small-file read per access."""

    name = "pytorch"

    def __init__(self, plan: ChunkingPlan, num_nodes: int, memory_bytes: int):
        self.plan = plan
        self.num_nodes = num_nodes
        self.caches = [
            _LRUBytes(memory_bytes, plan.file_sizes) for _ in range(num_nodes)
        ]
        self.stats = NodeStats()

    def access(self, r: int, pos: int, f: int, io_by_node: dict[int, StepIO]) -> int:
        self.stats.accesses += 1
        if self.caches[r].hit(f):
            self.stats.local_hits += 1
            return f
        self.stats.memory_misses += 1
        io = io_by_node.setdefault(r, StepIO())
        io.file_reads += 1
        io.disk_bytes += int(self.plan.file_sizes[f])
        self.stats.disk_bytes += int(self.plan.file_sizes[f])
        self.stats.filled_bytes += int(self.plan.file_sizes[f])
        self.caches[r].admit(f)
        return f


class CoorDLLoader:
    """Fixed-cache baseline with cross-node cache sharing (CoorDL/MinIO)."""

    name = "coordl"

    def __init__(self, plan: ChunkingPlan, num_nodes: int, memory_bytes: int, seed: int = 0):
        self.plan = plan
        self.num_nodes = num_nodes
        rng = np.random.default_rng(seed)
        order = rng.permutation(plan.num_files)
        # Pin a prefix of a random order on each node's memory budget,
        # partitioned so each file is cached on at most one node.
        self.cached_on = np.full(plan.num_files, -1, dtype=np.int32)
        budgets = [memory_bytes] * num_nodes
        node = 0
        for f in order:
            size = int(plan.file_sizes[f])
            placed = False
            for _ in range(num_nodes):
                if budgets[node] >= size:
                    self.cached_on[f] = node
                    budgets[node] -= size
                    placed = True
                    break
                node = (node + 1) % num_nodes
            if not placed:
                break
            node = (node + 1) % num_nodes
        self.stats = NodeStats()

    def access(self, r: int, pos: int, f: int, io_by_node: dict[int, StepIO]) -> int:
        self.stats.accesses += 1
        holder = int(self.cached_on[f])
        io = io_by_node.setdefault(r, StepIO())
        if holder == r:
            self.stats.local_hits += 1
        elif holder >= 0:
            # Peer-cache fetch over the network (CoorDL's cross-node sharing).
            self.stats.remote_requests += 1
            io.net_messages += 1
            io.net_bytes += int(self.plan.file_sizes[f])
            self.stats.net_bytes += int(self.plan.file_sizes[f])
        else:
            self.stats.memory_misses += 1
            io.file_reads += 1
            io.disk_bytes += int(self.plan.file_sizes[f])
            self.stats.disk_bytes += int(self.plan.file_sizes[f])
        return f


class NoIOLoader:
    """Upper bound: data generated in memory, zero I/O demand."""

    name = "no_io"

    def __init__(self, plan: ChunkingPlan, num_nodes: int):
        self.plan = plan
        self.num_nodes = num_nodes
        self.stats = NodeStats()

    def access(self, r: int, pos: int, f: int, io_by_node: dict[int, StepIO]) -> int:
        self.stats.accesses += 1
        self.stats.local_hits += 1
        return f


def run_baseline_epoch(
    loader, sampler: EpochSampler, epoch: int, batch_per_node: int
) -> tuple[NodeStats, list[list[StepIO]]]:
    """Drive one epoch of a baseline loader with the DP-barrier step loop."""
    import math

    seqs = sampler.node_sequences(epoch)
    num_nodes = loader.num_nodes
    steps = max(math.ceil(len(s) / batch_per_node) for s in seqs)
    per_node_step_io: list[list[StepIO]] = [[] for _ in range(num_nodes)]
    for step in range(steps):
        io_by_node: dict[int, StepIO] = {}
        for r in range(num_nodes):
            seq = seqs[r]
            lo, hi = step * batch_per_node, min((step + 1) * batch_per_node, seq.size)
            for pos in range(lo, hi):
                loader.access(r, pos, int(seq[pos]), io_by_node)
        for r in range(num_nodes):
            per_node_step_io[r].append(io_by_node.get(r, StepIO()))
    return loader.stats, per_node_step_io
