"""Dry-run machinery: run every (arch × shape × mesh) cell on DTensors over
meta tensors (``repro/launch/dryrun_lib.py``).

No parameters are ever materialised. The model is built on the meta
device; its parameters and the optimizer state are distributed over the
mesh as DTensors with the placements of :mod:`repro_torch.parallel.sharding`;
the cell's step runs eagerly under ``sharding_ctx(make_rules(...))`` on a
process group that moves no data (the fake group of ``dryrun.py``, or any
group whose mesh the caller built): the train step (forward, backward,
update), the prefill's last logits, or one decode step against a cache
placed by ``Model.cache_axes``. Each cell produces:

* FLOPs per device, from the local ops only. Every DTensor's local shard
  is a :class:`_Local` wrapper, so every op this device would run passes
  its ``__torch_dispatch__``, and there the FLOP formulas of
  ``torch.utils.flop_counter`` count it. A dispatch mode over the DTensor
  ops would see the *global* op (a [256x2048] @ [2048x5632] matmul sharded
  16x32 counts 5.9e9 there, 1.15e7 here) and, on some dispatch paths, the
  local one as well;
* bytes per device: operands + result of those ops (the dot-anchored
  proxy of the reference) plus collective results; the upper bound in
  ``memory["bytes_upper_bound"]``: the result bytes of every local op;
* collective bytes per device, by kind under the reference's names
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``):
  the result bytes of every functional collective a local shard goes
  through (DTensor's redistributions and ``moe_block_a2a``'s exchanges),
  with ``total_bytes`` and ``num_ops``;
* memory: argument and output bytes of the local shards, and temp bytes:
  the peak, over the step, of the bytes of the local storages alive then
  that the step allocated (torch's ``MemTracker`` refuses a module called
  more than once a step, as the microbatch loop calls the model).

The reference's ``parse_collectives`` and ``cpu_convert_overhead`` read
HLO text, and so does its ``raw_cost_analysis``; torch lowers to no HLO,
so they have no counterpart here (``raw_cost_analysis`` stays None).
"""

from __future__ import annotations

import dataclasses
import time
import weakref

import torch
from torch import nn
from torch.utils._pytree import tree_map

from ..configs import RunConfig, cell_status, get_config, get_shape
from ..models.common import flatten_tree
from ..models.transformer import Model
from ..optim.optimizers import make_optimizer
from ..parallel import sharding as shd
from ..parallel.axes import ShardingRules, sharding_ctx
from ..train.train_step import build_train_step
from .roofline import HW
from .specs import decode_input_specs, train_input_specs

__all__ = ["run_cell", "default_run_cfg", "CellResult", "HW", "count_local"]

#: torch's functional collectives -> the reference's (HLO) names.
_COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",  # DTensor's shard-to-shard on a non-CPU mesh
}
_COUNTERS: list[dict] = []
#: Local storages alive: key -> [wrappers holding it, bytes]; their sum.
_STORAGES: dict[int, list] = {}
_LIVE = [0]


def _hold(local: "_Local") -> None:
    storage = local.inner.untyped_storage()
    key = storage._cdata
    entry = _STORAGES.get(key)
    if entry is None:
        entry = _STORAGES[key] = [0, storage.nbytes()]
        _LIVE[0] += entry[1]
        for c in _COUNTERS:
            c["peak"] = max(c["peak"], _LIVE[0])
    entry[0] += 1
    weakref.finalize(local, _release, key)


def _release(key: int) -> None:
    entry = _STORAGES[key]
    entry[0] -= 1
    if entry[0] == 0:
        _LIVE[0] -= entry[1]
        del _STORAGES[key]


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree) -> list:
    out = []
    tree_map(lambda t: out.append(t) if isinstance(t, torch.Tensor) else None, tree)
    return out


class _Local(torch.Tensor):
    """A DTensor's local shard: a meta tensor whose every op is counted
    (FLOPs, bytes, collectives) into the innermost :func:`count_local`."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @staticmethod
    def __new__(cls, inner: torch.Tensor):
        return torch.Tensor._make_wrapper_subclass(
            cls, inner.shape, strides=inner.stride(), storage_offset=inner.storage_offset(),
            dtype=inner.dtype, device=inner.device, requires_grad=False)

    def __init__(self, inner: torch.Tensor):
        self.inner = inner
        _hold(self)

    def __repr__(self) -> str:
        return f"_Local({tuple(self.shape)}, {self.dtype})"

    def __tensor_flatten__(self):
        return ["inner"], None

    @staticmethod
    def __tensor_unflatten__(inner_tensors, meta, outer_size, outer_stride):
        return _Local(inner_tensors["inner"])

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        wrappers = {}

        def unwrap(t):
            if isinstance(t, _Local):
                wrappers[id(t.inner)] = t
                return t.inner
            return t

        args_i, kwargs_i = tree_map(unwrap, args), tree_map(unwrap, kwargs)
        out = func(*args_i, **kwargs_i)
        if _COUNTERS:
            c = _COUNTERS[-1]
            pkt = func._overloadpacket
            results = _tensors(out)
            c["bytes_upper_bound"] += sum(_nbytes(t) for t in results if t._base is None)
            if pkt in flop_registry:
                c["flops"] += flop_registry[pkt](*args_i, **kwargs_i, out_val=out)
                operands = [a for a in args_i if isinstance(a, torch.Tensor)][:2]
                c["bytes_dots"] += sum(map(_nbytes, operands + results))
            kind = _COLLECTIVE_KINDS.get(func.__name__.split(".")[0])
            if kind is not None and func.namespace.startswith(("_c10d_functional", "_dtensor")):
                b = sum(map(_nbytes, results))
                c["coll"][kind] = c["coll"].get(kind, 0.0) + b
                c["bytes_dots"] += b  # collectives read+write HBM too
                c["num_ops"] += 1

        def wrap(t):
            if not isinstance(t, torch.Tensor) or isinstance(t, _Local):
                return t
            same = wrappers.get(id(t))  # an in-place op returns its input
            return _Local(t) if same is None else same

        return tree_map(wrap, out)


class count_local:
    """Context: counts the local ops of the DTensors made by
    :func:`distribute` while it is active; ``.counts`` after it."""

    def __enter__(self):
        self.counts = {"flops": 0, "bytes_dots": 0, "bytes_upper_bound": 0, "coll": {},
                       "num_ops": 0, "base": _LIVE[0], "peak": _LIVE[0]}
        _COUNTERS.append(self.counts)
        return self

    def __exit__(self, *exc):
        _COUNTERS.remove(self.counts)
        self.counts["temp"] = self.counts["peak"] - self.counts["base"]


def distribute(t: torch.Tensor, mesh, placements, *, requires_grad: bool = False):
    """A DTensor of ``t``'s global shape and dtype with ``placements`` over
    ``mesh`` (a NamedMesh), its local shard a counting meta tensor."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    dm = mesh.device_mesh
    local_shape, _ = compute_local_shape_and_global_offset(t.shape, dm, placements)
    local = _Local(torch.empty(local_shape, dtype=t.dtype, device="meta"))
    out = DTensor.from_local(local, dm, placements, run_check=False, shape=t.shape,
                             stride=t.stride())
    return out.requires_grad_(requires_grad)


def _lenient_views() -> None:
    """Let a DTensor ``view`` reshard its input where it must.

    ``aten.view`` is registered strict: a view that unflattens a sharded
    dim the mesh cannot split evenly (``(b, s, kvh*hd)`` sharded 4 ways
    on its last dim, viewed as ``(b, s, 2, 32)``) raises, where the
    reference's GSPMD reshards and ``aten.reshape`` would redistribute.
    Registered non-strict it redistributes its input first, like reshape.
    A torch without the ``strict_view`` switch has lenient views already.
    """
    import inspect

    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops import _view_ops

    if "strict_view" in inspect.signature(_view_ops.register_op_strategy_map).parameters:
        _view_ops.register_op_strategy_map(torch.ops.aten.view.default, torch.Tensor.view,
                                           schema_info=RuntimeSchemaInfo(1), strict_view=False)


def _local_bytes(tree) -> float:
    return float(sum(_nbytes(t.to_local() if hasattr(t, "to_local") else t)
                     for t in _tensors(tree)))


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    status: str
    step_kind: str = ""
    compile_s: float = 0.0
    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    collectives: dict | None = None
    memory: dict | None = None
    param_count: float = 0.0
    error: str = ""
    raw_cost_analysis: dict | None = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def default_run_cfg(arch: str) -> RunConfig:
    """Per-arch RunConfig overrides needed to fit / balance (DESIGN.md §5).

    These are the *baseline* (paper-faithful recipe) settings whose roofline
    is recorded for every cell; the §Perf hillclimb changes them per cell.
    """
    if arch == "kimi-k2-1t-a32b":
        # 1T params on 512 x 16 GB: bf16 params + factored opt WITHOUT an
        # fp32 master (4 TB > global HBM), FSDP everywhere, full remat,
        # sequence-parallel residuals (activations / 16).
        return RunConfig(
            optimizer="adafactor",
            fsdp=True,
            remat="full",
            master_fp32=False,
            seq_parallel=True,
            microbatch=4,
        )
    if arch in ("starcoder2-15b", "llava-next-34b", "phi3-medium-14b", "deepseek-7b"):
        return RunConfig(optimizer="adamw", zero1=True, remat="full", microbatch=8,
                         seq_parallel=True)
    if arch == "deepseek-moe-16b":
        return RunConfig(optimizer="adamw", zero1=True, remat="full", microbatch=8)
    return RunConfig(optimizer="adamw", zero1=True, remat="full", microbatch=4)


def optimized_run_cfg(arch: str) -> tuple[RunConfig, object]:
    """§Perf-optimized (beyond-paper) per-arch configs: (RunConfig, cfg_override).

    The reference's table: sub-2B models go pure-DP; 7-34B dense go
    ZeRO-3+DP; MoEs keep EP (kimi via the all-to-all MoE); zamba
    additionally tunes the SSD chunk.
    """
    cfg = get_config(arch)
    if arch in ("tinyllama-1.1b", "xlstm-350m", "hubert-xlarge"):
        return RunConfig(zero1=True, remat="dots", parallelism="dp_only"), None
    if arch == "zamba2-1.2b":
        return (
            RunConfig(zero1=True, remat="dots", parallelism="dp_only"),
            dataclasses.replace(cfg, ssm_chunk=64),
        )
    if arch in ("deepseek-7b", "phi3-medium-14b", "starcoder2-15b", "llava-next-34b"):
        return RunConfig(zero1=True, fsdp=True, remat="full", parallelism="dp_only"), None
    if arch == "deepseek-moe-16b":
        return RunConfig(zero1=True, fsdp=True, remat="full", parallelism="dp_only"), None
    if arch == "kimi-k2-1t-a32b":
        return (
            RunConfig(optimizer="adafactor", fsdp=True, remat="full",
                      master_fp32=False, seq_parallel=True, microbatch=4),
            dataclasses.replace(cfg, moe_impl="a2a"),
        )
    return default_run_cfg(arch), None


def _distribute_params(model: Model, mesh, run_cfg: RunConfig, *, requires_grad: bool) -> dict:
    """Replace every parameter of the meta ``model`` by a DTensor with its
    ``param_shardings`` placements; returns the plain meta tensors."""
    flat = flatten_tree(model.values())
    placements = shd.param_shardings(mesh, run_cfg, flat, model.param_axes())
    for path, t in flat.items():
        *parents, name = path.split("/")
        owner = model.get_submodule(".".join(parents))
        setattr(owner, name, nn.Parameter(distribute(t, mesh, placements[path]),
                                          requires_grad=requires_grad))
    return flat


def _distribute_tree(tree, placements, mesh):
    if isinstance(tree, dict):
        return {k: _distribute_tree(v, placements[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_distribute_tree(v, p, mesh) for v, p in zip(tree, placements)]
    return distribute(tree, mesh, placements)


def _mesh_name(mesh) -> str:
    return "x".join(f"{k}{v}" for k, v in mesh.shape.items())


def _train(model, run_cfg, mesh, cfg, shape):
    optimizer = make_optimizer(run_cfg)
    flat = _distribute_params(model, mesh, run_cfg, requires_grad=True)
    opt_meta = optimizer.init(flat)
    opt_pl = shd.opt_state_shardings(mesh, run_cfg, opt_meta,
                                     optimizer.state_axes(model.param_axes()))
    opt = _distribute_tree(opt_meta, opt_pl, mesh)
    batch_sds = train_input_specs(cfg, shape)
    batch_pl = shd.batch_shardings(mesh, batch_sds, run_cfg)
    batch = {k: distribute(v, mesh, batch_pl[k]) for k, v in batch_sds.items()}
    state = {"values": model.values(), "opt": opt,
             "step": torch.zeros((), dtype=torch.int32, device=model.device)}
    args = _local_bytes([state["values"], opt, batch])
    step = build_train_step(model, run_cfg, optimizer)

    def run():
        _, metrics = step(state, batch)
        return _local_bytes([state["values"], opt]) + _local_bytes(metrics)

    return "train_step", args, run


def _prefill(model, run_cfg, mesh, cfg, shape):
    _distribute_params(model, mesh, run_cfg, requires_grad=False)
    batch_sds = {k: v for k, v in train_input_specs(cfg, shape).items()
                 if k in ("tokens", "patch_embeds", "frames")}
    batch_pl = shd.batch_shardings(mesh, batch_sds, run_cfg)
    batch = {k: distribute(v, mesh, batch_pl[k]) for k, v in batch_sds.items()}
    args = _local_bytes([model.values(), batch])

    @torch.no_grad()
    def run():
        logits, _ = model(batch)
        return _local_bytes(logits[:, -1:].redistribute(
            mesh.device_mesh, shd.replicated(mesh)))

    return "serve_prefill", args, run


def _decode(model, run_cfg, mesh, cfg, shape):
    _distribute_params(model, mesh, run_cfg, requires_grad=False)
    b = shape.global_batch
    specs = model.cache_specs(b, shape.seq_len)
    axes = model.cache_axes(b, shape.seq_len, tp=mesh.shape.get("model"))
    rules = ShardingRules(mesh, shd.activation_rules(mesh, run_cfg))
    caches = [{name: distribute(torch.empty(shp, dtype=dt, device="meta"), mesh,
                                rules.placements_for(ax[name], shp))
               for name, (shp, dt) in spec.items()} for spec, ax in zip(specs, axes)]
    dec = decode_input_specs(cfg, shape)
    tokens = distribute(dec["tokens"], mesh, shd.batch_shardings(mesh, dec, run_cfg)["tokens"])
    args = _local_bytes([model.values(), caches, tokens])

    @torch.no_grad()  # build_decode_step's inference mode refuses DTensor views
    def run():
        logits, new = model.decode_step(caches, tokens, shape.seq_len - 1)
        return _local_bytes(logits.redistribute(mesh.device_mesh, shd.replicated(mesh))) \
            + _local_bytes(new)

    return "serve_decode", args, run


_STEPS = {"train": _train, "prefill": _prefill, "decode": _decode}


def run_cell(
    arch: str,
    shape_name: str,
    mesh,
    *,
    run_cfg: RunConfig | None = None,
    cfg_override=None,
) -> CellResult:
    """Run one cell on DTensors over meta tensors; returns roofline raw terms.

    ``mesh`` is a NamedMesh over a process group that moves no data (the
    fake group: ``dryrun.py``). ``cfg_override`` lets §Perf iterations
    vary ModelConfig knobs (ssm_chunk, attn_chunk, ...) without touching
    the registry. ``compile_s`` holds the step's wall time here (there is
    no compile).
    """
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = cfg_override or get_config(arch)
    shape = get_shape(shape_name)
    mesh_name = _mesh_name(mesh)
    status = cell_status(cfg, shape)
    if status != "run":
        return CellResult(arch, shape_name, mesh_name, status)

    run_cfg = run_cfg or default_run_cfg(arch)
    rules = ShardingRules(mesh, shd.activation_rules(mesh, run_cfg))
    _lenient_views()
    t0 = time.time()
    try:
        model = Model(cfg, device="meta")
        step_kind, args, run = _STEPS[shape.kind](model, run_cfg, mesh, cfg, shape)
        with implicit_replication(), sharding_ctx(rules), count_local() as counter:
            outputs = run()
    except Exception as e:  # a failing cell is a bug; record it loudly
        return CellResult(
            arch, shape_name, mesh_name, "FAILED", error=f"{type(e).__name__}: {e}"
        )

    counts = counter.counts
    coll = {k: float(v) for k, v in counts["coll"].items()}
    coll["total_bytes"] = float(sum(counts["coll"].values()))
    coll["num_ops"] = counts["num_ops"]
    memory = {
        "argument_size_in_bytes": args,
        "output_size_in_bytes": outputs,
        "temp_size_in_bytes": float(counts["temp"]),
        # the reference's key, so its roofline reads this artifact too: here
        # there is no CPU-backend convert overhead to take off the temp
        "temp_tpu_adjusted": float(counts["temp"]),
        "generated_code_size_in_bytes": 0.0,
        "bytes_upper_bound": float(counts["bytes_upper_bound"]),
    }
    return CellResult(
        arch=arch,
        shape=shape_name,
        mesh=mesh_name,
        status="ok",
        step_kind=step_kind,
        compile_s=time.time() - t0,
        flops_per_device=float(counts["flops"]),
        bytes_per_device=float(counts["bytes_dots"]),
        collectives=coll,
        memory=memory,
        param_count=float(cfg.param_count()),
    )
