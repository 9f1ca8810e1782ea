"""Logical-axis sharding: annotation helpers usable from model code
(``repro/parallel/axes.py``).

Model code names tensor dimensions with *logical* axes ("batch", "embed",
"heads", ...). A :class:`ShardingRules` context maps logical axes to mesh
axes, with the reference's two safety rails:

* divisibility — a rule is applied to a dim only if the mesh-axis size
  divides it (otherwise that dim is replicated), so no shard is uneven;
* no-mesh no-op — without an active context ``shard()`` is the identity,
  so single-device runs execute the exact same model code.

A spec is a port-local :class:`PartitionSpec`, a tuple with one entry per
tensor dim: ``None``, a mesh-axis name or a tuple of names.
:meth:`ShardingRules.placements_for` turns it into DTensor placements, one
``Shard(dim)`` / ``Replicate()`` per mesh dim. ``shard()`` constrains a
DTensor by ``redistribute`` to those placements (a partial sum is reduced
there), and its gradient likewise on the way back; on a plain tensor it
does nothing, context or not, which is how eager code on real ranks
(``moe_block_a2a``) runs under a context.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = [
    "NamedMesh",
    "PartitionSpec",
    "ShardingRules",
    "current_ctx",
    "logical_spec",
    "per_shard",
    "shard",
    "sharding_ctx",
]

_LOCAL = threading.local()


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh-axis name or a tuple of them."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class NamedMesh:
    """A ``DeviceMesh`` seen as the reference sees a mesh: ``shape`` is a
    ``{name: size}`` dict in mesh-dim order."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.shape = dict(zip(device_mesh.mesh_dim_names, device_mesh.shape))

    def coordinate(self, name: str) -> int:
        """This rank's index along mesh axis ``name``."""
        return self.device_mesh.get_local_rank(name)

    def __repr__(self) -> str:
        return f"NamedMesh({self.shape}, {self.device_mesh.device_type!r})"


class ShardingRules:
    """logical axis name -> mesh axis (str), tuple of mesh axes, or None."""

    def __init__(self, mesh, rules: dict[str, object]):
        self.mesh = mesh
        self.rules = dict(rules)

    def _mesh_size(self, target) -> int:
        if target is None:
            return 1
        if isinstance(target, tuple):
            return math.prod(self.mesh.shape[t] for t in target)
        return self.mesh.shape[target]

    def spec_for(self, axes: tuple[str | None, ...], shape: tuple[int, ...]) -> PartitionSpec:
        assert len(axes) == len(shape), f"axes {axes} vs shape {shape}"
        parts, used = [], set()
        for name, dim in zip(axes, shape):
            target = self.rules.get(name) if name is not None else None
            if target is None:
                parts.append(None)
                continue
            flat = target if isinstance(target, tuple) else (target,)
            if any(t in used for t in flat):
                parts.append(None)  # a mesh axis may appear only once per spec
                continue
            if dim % self._mesh_size(target) != 0:
                parts.append(None)  # divisibility rail (replicate instead)
                continue
            used.update(flat)
            parts.append(target)
        return PartitionSpec(*parts)

    def placements_for(self, axes, shape) -> tuple:
        """DTensor placements of ``spec_for(axes, shape)``, one per mesh dim
        in the mesh's order: ``Shard(i)`` where tensor dim ``i`` is split
        over that mesh axis, else ``Replicate()``."""
        spec = self.spec_for(axes, tuple(shape))
        where = {}
        for dim, part in enumerate(spec):
            for name in (part if isinstance(part, tuple) else (part,)):
                if name is not None:
                    where[name] = dim
        return tuple(Shard(where[n]) if n in where else Replicate() for n in self.mesh.shape)


def current_ctx() -> ShardingRules | None:
    return getattr(_LOCAL, "ctx", None)


@contextlib.contextmanager
def sharding_ctx(rules: ShardingRules):
    prev = current_ctx()
    _LOCAL.ctx = rules
    try:
        yield rules
    finally:
        _LOCAL.ctx = prev


def logical_spec(axes, shape) -> PartitionSpec:
    ctx = current_ctx()
    return PartitionSpec() if ctx is None else ctx.spec_for(axes, shape)


class _Constrain(torch.autograd.Function):
    """``redistribute`` whose backward first brings the gradient to the
    same placements: a sharding constraint applies to the cotangent too,
    as JAX transposes ``with_sharding_constraint``. Without it a partial
    gradient would have to travel back to a masked partial (a vocab-sharded
    embedding's output), which DTensor cannot do."""

    @staticmethod
    def forward(ctx, x, device_mesh, placements):
        ctx.target = (device_mesh, placements)
        return x.redistribute(device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(*ctx.target), None, None


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Constrain ``x``'s sharding (and its gradient's) by logical axis
    names (no-op without ctx, and for a plain tensor)."""
    ctx = current_ctx()
    if ctx is None or not isinstance(x, DTensor):
        return x
    return _Constrain.apply(x, ctx.mesh.device_mesh, ctx.placements_for(axes, x.shape))


def per_shard(fn, ref, split_dims, inputs, outputs):
    """``fn`` on each device's local blocks, where the work is independent
    along the dims that ``ref`` is split over (a ``shard_map``).

    ``ref`` is a DTensor whose placements decide the blocks; ``inputs``
    are ``(tensor, dims)`` pairs, ``dims`` mapping a dim of ``ref`` to the
    matching dim of ``tensor`` (a dim it lacks stays whole: B and C of the
    SSD scan are shared by the heads); ``outputs`` one such map for each
    of ``fn``'s results. Each input is redistributed to ``ref``'s split,
    ``fn`` runs on the local tensors, and its results come back as
    DTensors of that split. When ``ref`` is a plain tensor, or is split
    over a dim outside ``split_dims`` (or holds a partial sum), ``fn``
    runs on the inputs as they are: GSPMD partitions a batch dim of an
    einsum where DTensor, op by op, may flatten two split dims into one
    and replicate one of them.
    """
    args = [t for t, _ in inputs]
    if not isinstance(ref, DTensor) or any(
            not (pl.is_replicate() or (pl.is_shard() and pl.dim in split_dims))
            for pl in ref.placements):
        return fn(*args)
    mesh = ref.device_mesh

    def placements(dims):
        return tuple(Shard(dims[pl.dim]) if pl.is_shard() and pl.dim in dims else Replicate()
                     for pl in ref.placements)

    local = [t if t is None else t.redistribute(mesh, placements(dims)).to_local()
             for t, dims in inputs]
    out = fn(*local)
    single = not isinstance(out, tuple)
    out = (out,) if single else out
    out = tuple(DTensor.from_local(o.contiguous(), mesh, placements(dims), run_check=False)
                for o, dims in zip(out, outputs))
    return out[0] if single else out
