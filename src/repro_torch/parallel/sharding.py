"""Mesh-level sharding policies: DP / TP / EP / FSDP / ZeRO-1
(``repro/parallel/sharding.py``).

One place defines how every logical axis maps onto the mesh:

* params   — TP over "model" (heads/kv/mlp/experts/vocab/inner dims);
             optionally FSDP ("embed" -> "data") for models that cannot
             replicate (kimi-k2-1t).
* opt state — ZeRO-1: same as params *plus* "embed" -> "data", so master
             weights and moments shard over the data axis even when params
             replicate (the in-place update then redistributes the
             gradient to the state's placements).
* batch    — "batch" -> ("pod", "data") (the pod axis is plain extra DP).
* activations — annotated inline in model code via parallel.axes.shard.

The tables are the reference's. The ``*_shardings`` functions return
DTensor placements (one per mesh dim) in place of ``NamedSharding``s,
keyed like the port's trees: ``param_shardings`` by parameter path (the
reference's tree paths, ``Model.param_axes()``), ``opt_state_shardings``
like the optimizer state (``Optimizer.state_axes``), ``batch_shardings``
like the batch dict.

The divisibility rail in ShardingRules replicates any dim a rule cannot
split evenly (e.g. hubert's 504-way vocab head, long_500k's batch=1).
"""

from __future__ import annotations

import math

from torch.distributed.tensor import Replicate, Shard

from ..configs.base import RunConfig
from .axes import ShardingRules

__all__ = [
    "param_rules",
    "zero1_rules",
    "activation_rules",
    "make_rules",
    "param_shardings",
    "opt_state_shardings",
    "batch_shardings",
    "replicated",
]


def _dp_axes(mesh, run_cfg: RunConfig | None = None) -> tuple:
    axes = ["pod", "data"]
    if run_cfg is not None and run_cfg.parallelism == "dp_only":
        axes.append("model")  # model axis joins the batch shards
    return tuple(a for a in axes if a in mesh.shape)


def param_rules(mesh, run_cfg: RunConfig) -> dict:
    if run_cfg.parallelism == "dp_only":
        # replicate params everywhere; the whole mesh is data-parallel
        rules = {k: None for k in (
            "vocab", "heads_flat", "kv_flat", "mlp", "experts", "inner_flat",
            "inner_heads", "embed2", "layers",
        )}
        rules["embed"] = _dp_axes(mesh) if run_cfg.fsdp else None
        return rules
    return {
        "vocab": "model",
        "heads_flat": "model",
        "kv_flat": "model",
        "mlp": "model",
        "experts": "model",
        "inner_flat": "model",
        "inner_heads": "model",
        "embed2": "model",
        "layers": None,
        "embed": _dp_axes(mesh) if run_cfg.fsdp else None,
    }


def zero1_rules(mesh, run_cfg: RunConfig) -> dict:
    rules = dict(param_rules(mesh, run_cfg))
    rules["embed"] = _dp_axes(mesh, run_cfg)  # shard opt state over data even w/o fsdp
    return rules


def activation_rules(mesh, run_cfg: RunConfig) -> dict:
    if run_cfg.parallelism == "dp_only":
        dp = _dp_axes(mesh, run_cfg)
        rules = {k: None for k in (
            "embed_act", "seq_act", "heads", "heads_r", "seq_tp", "mlp",
            "experts", "vocab", "inner_heads", "kv_heads", "kv_seq",
            "inner_flat", "embed_state", "layers", "embed",
        )}
        rules["batch"] = dp
        return rules
    return {
        "batch": _dp_axes(mesh),
        "embed_act": None,
        "seq_act": "model" if run_cfg.seq_parallel else None,
        "heads": "model",
        "heads_r": None,
        "seq_tp": "model",
        "mlp": "model",
        "experts": "model",
        "vocab": "model",
        "inner_heads": "model",
        # cache/state axes (decode):
        "kv_heads": "model",
        "kv_seq": "model",
        "inner_flat": "model",
        "embed_state": "model",
        "layers": None,
        # param axes can appear in constraints too (e.g. logits):
        "embed": None,
    }


def make_rules(mesh, run_cfg: RunConfig) -> ShardingRules:
    """Rules for *activations* (installed as the sharding_ctx)."""
    return ShardingRules(mesh, activation_rules(mesh, run_cfg))


# ---------------------------------------------------------------- shardings
def _map(fn, values, axes):
    """``fn(leaf, leaf_axes)`` over a values tree (nested dicts / lists
    whose leaves have a ``shape``) and its axes tree (tuple leaves)."""
    if isinstance(values, dict):
        return {k: _map(fn, v, axes[k]) for k, v in values.items()}
    if isinstance(values, list):
        return [_map(fn, v, a) for v, a in zip(values, axes)]
    return fn(values, axes)


def param_shardings(mesh, run_cfg: RunConfig, values, axes_tree):
    rules = ShardingRules(mesh, param_rules(mesh, run_cfg))
    return _map(lambda v, a: rules.placements_for(a, v.shape), values, axes_tree)


def opt_state_shardings(mesh, run_cfg: RunConfig, opt_state, state_axes_tree):
    """ZeRO-1 placements for the optimizer state tree.

    ``state_axes_tree`` comes from ``Optimizer.state_axes`` (each optimizer
    declares the logical axes of its own state, incl. adafactor's factored
    vr/vc entries), so this is a plain leaf-wise rule application.
    """
    rules = ShardingRules(
        mesh, zero1_rules(mesh, run_cfg) if run_cfg.zero1 else param_rules(mesh, run_cfg)
    )
    return _map(lambda leaf, ax: rules.placements_for(ax, leaf.shape), opt_state,
                state_axes_tree)


def batch_shardings(mesh, batch_tree, run_cfg: RunConfig | None = None):
    dp = _dp_axes(mesh, run_cfg)
    dp_size = math.prod(mesh.shape[a] for a in dp)

    def placements(leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0 or shape[0] % dp_size != 0:
            return replicated(mesh)
        return tuple(Shard(0) if n in dp else Replicate() for n in mesh.shape)

    return {k: placements(v) for k, v in batch_tree.items()}


def replicated(mesh) -> tuple:
    return tuple(Replicate() for _ in mesh.shape)
