"""Model assembly: every block kind of the reference (``repro/models/transformer.py``).

The parameter tree is the reference's: each segment's per-layer leaves are
stacked on a leading layers axis (``(L, d)`` norms, ``(L, in, out)``
weights), so the state-dict names are the reference tree paths with ``.``
for ``/`` (``segments.0.attn.wq`` is ``segments/0/attn/wq``), and
``values()`` returns the reference's nested tree of these parameters.
That matters beyond naming: AdamW decays every tensor of rank >= 2, so
the stacked ``(L, d)`` norm scales are decayed, as in the reference.

The block kinds, each a pre-norm residual block:

- ``attn_mlp``: attention + SwiGLU MLP (the dense family);
- ``attn_dense_moe``: the same with ``d_ff = moe_dense_ff``, the leading
  dense layers of a MoE stack;
- ``attn_moe``: attention + the routed/shared experts of ``moe.py``, whose
  load-balance loss ``forward`` sums into the ``aux`` it returns;
- ``mamba2``: the Mamba-2 mixer (zamba2, nemotron-h);
- ``moe`` and ``attn``: the single-mixer layers of a ``layer_pattern``
  layout (nemotron-h), a norm then the experts of ``moe_share_block`` (a
  share of the router's experts, dropless) or GQA attention. The model
  holds each ``moe`` layer's correction bias (``router_bias``, f32, zero;
  it picks experts and weighs nothing) and its rows counter
  (``expert_rows``, the rows a training step routed to each held expert,
  accumulated on the card: ``device_counters``) as buffers, outside the
  parameter tree;
- ``mla_dense`` and ``mla_moe`` (family ``mla_moe``: Kimi-K2, DeepSeek-V3's
  layout): multi-head latent attention (``attention.mla_block``) + the
  SwiGLU MLP of ``moe_dense_ff`` for the ``moe_first_dense`` leading layers,
  then + the expert share of ``moe_share_block`` (SwiGLU experts), whose
  correction bias and rows counter the model holds as for ``moe``. An
  MLA model has no decode cache: prefill and decode raise;
- ``shared_attn``: zamba2's *shared* attention+MLP block, one unstacked
  parameter set under ``shared_attn`` applied at every site, whose
  ``segments`` entry is an empty placeholder, the reference's tree;
- ``mlstm`` / ``slstm``: the xLSTM cells of ``xlstm.py``.

The reference scans a segment with ``lax.scan``; here a Python loop walks
the layers of ``unbind(0)`` views (one stacked gradient per leaf on the
way back). ``remat="dots"`` / ``"full"`` checkpoint each layer with
``torch.utils.checkpoint`` (non-reentrant): only the layer inputs are
kept, and the attention logits are recomputed in the backward pass.

Serving mirrors the reference: ``forward(..., want_cache=True)`` (prefill,
attention through the flash-attention kernel, the Mamba-2 scan through
``ssd_scan``) also returns each segment's cache entry: ``{"k", "v"}``
stacks (L, B, S, KVH, D) for the attention kinds, the final recurrent
states for the others (f32 SSM / mLSTM / sLSTM states, the Mamba-2 conv
context in the compute dtype). ``cache_specs`` / ``init_cache`` give the
decode cache, stacked per segment like the parameters (rotating window
buffers when ``cfg.window`` is set, int8 with bf16 scales when
``cfg.kv_cache_dtype == "int8"``); ``decode_step`` runs one token through
every layer against it (attention through the decode-attention kernel, an
``attn_moe`` layer's experts through ``moe_block`` on that token),
updating it in place.

The frontend stubs are the reference's: a ``frontend`` leaf of shape
``(frontend_dim, d_model)`` projects precomputed inputs into the
decoder. ``patch`` (llava) puts ``patch_embeds @ frontend`` before the
embedded tokens; ``frame`` (hubert) feeds ``frames @ frontend`` in place of
them, so the token embedding is never read (its gradient is zero, and the
optimizers still decay it, as the reference's do). ``decode_step`` embeds
tokens only.

Sharding: ``param_axes`` / ``cache_axes`` give every parameter and cache
leaf its logical axes (the reference's ``Param`` axes, keyed by tree
path), and the reference's ``shard()`` sites constrain activations when a
``sharding_ctx`` is installed and the model runs on DTensors (the dry
run); otherwise they are the identity. The port adds two sites, each
sublayer's output (``_residual``) and decode's embedding, and computes
attention and the SSD scan per (batch, head) block (``per_shard``):
DTensor propagates op by op, GSPMD over the whole program. With
``moe_impl="a2a"`` an
``attn_moe`` layer's full-sequence pass goes through ``moe_block_a2a``,
which needs a context whose mesh has a "model" axis.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels.common import resolve_device
from ..parallel.axes import shard
from .attention import (
    attention_block,
    decode_attention_block,
    init_attention,
    init_mla,
    mla_block,
    mla_shapes,
    position,
)
from .common import flatten_tree, normal_init, rms_norm
from .mamba2 import init_mamba2, mamba2_block, mamba2_decode, mamba2_shapes, mamba2_state_shape
from .mlp import init_mlp, mlp_block
from .moe import (
    init_moe,
    init_moe_share,
    moe_block,
    moe_block_a2a,
    moe_share_block,
    moe_share_shapes,
    recomputing,
)
from .xlstm import (
    _mlstm_dims,
    _slstm_dims,
    init_mlstm,
    init_slstm,
    mlstm_block,
    mlstm_decode,
    mlstm_state_shape,
    slstm_block,
    slstm_decode,
    slstm_state_shape,
)

__all__ = ["ATTN_KINDS", "Model", "build_model"]

ATTN_KINDS = ("attn_mlp", "attn_dense_moe", "attn_moe", "shared_attn", "attn")
#: Multi-head latent attention's kinds, and the kinds that hold an expert
#: share (a correction bias and a rows counter each).
MLA_KINDS = ("mla_dense", "mla_moe")
SHARE_KINDS = ("moe", "mla_moe")
REMAT_MODES = ("none", "dots", "full")
#: The recurrent kinds: (full-sequence block, one-token decode, parameter key).
_RECURRENT = {
    "mamba2": (mamba2_block, mamba2_decode, "mixer"),
    "mlstm": (mlstm_block, mlstm_decode, "cell"),
    "slstm": (slstm_block, slstm_decode, "cell"),
}


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ----------------------------------------------------------------- blocks
def _ffn_width(kind, cfg) -> int:
    dense = kind in ("attn_dense_moe", "mla_dense")
    return (cfg.moe_dense_ff or cfg.d_ff) if dense else cfg.d_ff


def _block_shapes(kind: str, cfg: ModelConfig) -> dict:
    """One layer's parameter tree as shapes (the reference's ``_init_block``)."""
    d, hd = cfg.d_model, cfg.head_dim_
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    attn = {"wq": (d, h * hd), "wk": (d, kvh * hd), "wv": (d, kvh * hd), "wo": (h * hd, d)}
    if kind == "moe":
        return {"ln": (d,), "moe": moe_share_shapes(cfg)}
    if kind == "attn":
        return {"ln": (d,), "attn": attn}
    if kind in MLA_KINDS:
        tree = {"ln1": (d,), "ln2": (d,), "attn": mla_shapes(cfg)}
        if kind == "mla_moe":
            tree["moe"] = moe_share_shapes(cfg)
        else:
            f = _ffn_width(kind, cfg)
            tree["mlp"] = {"wi_gate": (d, f), "wi_up": (d, f), "wo": (f, d)}
        return tree
    if kind in ATTN_KINDS:
        tree = {"ln1": (d,), "ln2": (d,), "attn": attn}
        if kind == "attn_moe":
            e, f = cfg.moe_num_experts, cfg.d_ff
            tree["moe"] = {"router": (d, e), "wi_gate": (e, d, f), "wi_up": (e, d, f),
                           "wo": (e, f, d)}
            if cfg.moe_num_shared:
                sf = f * cfg.moe_num_shared
                tree["moe"]["shared"] = {"wi_gate": (d, sf), "wi_up": (d, sf), "wo": (sf, d)}
        else:
            f = _ffn_width(kind, cfg)
            tree["mlp"] = {"wi_gate": (d, f), "wi_up": (d, f), "wo": (f, d)}
        return tree
    if kind == "mamba2":
        return {"ln": (d,), "mixer": mamba2_shapes(cfg)}
    if kind == "mlstm":
        di, heads, _ = _mlstm_dims(cfg)
        return {"ln": (d,), "cell": {
            "w_up": (d, 2 * di), "wq": (di, di), "wk": (di, di), "wv": (di, di),
            "w_i": (di, heads), "w_f": (di, heads), "b_f": (heads,), "out_norm": (di,),
            "w_down": (di, d)}}
    if kind == "slstm":
        _, heads, dh = _slstm_dims(cfg)
        cell = {"out_norm": (d,), "w_out": (d, d)}
        for g in ("z", "i", "f", "o"):
            cell.update({f"w_{g}": (d, d), f"r_{g}": (heads, dh, dh), f"b_{g}": (d,)})
        return {"ln": (d,), "cell": cell}
    raise ValueError(kind)


def _block_axes(kind: str, cfg: ModelConfig) -> dict:
    """One layer's logical axes, the tree of :func:`_block_shapes` (the
    reference's ``Param`` axes)."""
    attn = {"wq": ("embed", "heads_flat"), "wk": ("embed", "kv_flat"),
            "wv": ("embed", "kv_flat"), "wo": ("heads_flat", "embed")}
    if kind == "attn":
        return {"ln": ("embed",), "attn": attn}
    mlp = {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"), "wo": ("mlp", "embed")}
    experts = {"router": ("embed", None), "wi_gate": ("experts", "embed", None),
               "wi_up": ("experts", "embed", None), "wo": ("experts", None, "embed")}
    # the leaves an expert share holds (moe_share_shapes), each with its axes
    share = {k: ({n: mlp[n] for n in v} if k == "shared" else experts[k])
             for k, v in moe_share_shapes(cfg).items()}
    if kind == "moe":
        return {"ln": ("embed",), "moe": share}
    if kind in MLA_KINDS:
        mla = {"wq_a": ("embed", None), "q_norm": (None,), "wq_b": (None, "heads_flat"),
               "wkv_a": ("embed", None), "kv_norm": (None,), "wkv_b": (None, "heads_flat"),
               "wo": ("heads_flat", "embed")}
        tree = {"ln1": ("embed",), "ln2": ("embed",), "attn": mla}
        if kind == "mla_moe":
            tree["moe"] = share
        else:
            tree["mlp"] = mlp
        return tree
    if kind in ATTN_KINDS:
        tree = {"ln1": ("embed",), "ln2": ("embed",), "attn": attn}
        if kind == "attn_moe":
            tree["moe"] = {"router": ("embed", None), "wi_gate": ("experts", "embed", None),
                           "wi_up": ("experts", "embed", None),
                           "wo": ("experts", None, "embed")}
            if cfg.moe_num_shared:
                tree["moe"]["shared"] = mlp
        else:
            tree["mlp"] = mlp
        return tree
    if kind == "mamba2":
        mixer = {"in_proj": ("embed", "inner_flat"), "conv_w": (None, "inner_flat"),
                 "conv_b": ("inner_flat",), "A_log": ("heads",), "dt_bias": ("heads",),
                 "D": ("heads",), "out_proj": ("inner_flat", "embed")}
        if "norm" in mamba2_shapes(cfg):
            mixer["norm"] = ("inner_flat",)
        return {"ln": ("embed",), "mixer": mixer}
    if kind == "mlstm":
        flat = ("inner_flat", "inner_flat")
        return {"ln": ("embed",), "cell": {
            "w_up": ("embed", "inner_flat"), "wq": flat, "wk": flat, "wv": flat,
            "w_i": ("inner_flat", None), "w_f": ("inner_flat", None), "b_f": (None,),
            "out_norm": ("inner_flat",), "w_down": ("inner_flat", "embed")}}
    if kind == "slstm":
        cell = {"out_norm": ("embed",), "w_out": ("embed", "embed2")}
        for g in ("z", "i", "f", "o"):
            cell.update({f"w_{g}": ("embed", "embed2"), f"r_{g}": ("inner_heads", None, None),
                         f"b_{g}": ("embed",)})
        return {"ln": ("embed",), "cell": cell}
    raise ValueError(kind)


def _init_block(kind: str, gen, cfg: ModelConfig, dtype) -> dict:
    """One layer's parameters, drawn in the reference's order."""
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device)  # noqa: E731
    if kind == "moe":
        return {"ln": zeros(), "moe": init_moe_share(gen, cfg, dtype)}
    if kind == "attn":
        return {"ln": zeros(), "attn": init_attention(gen, cfg, dtype)}
    if kind == "mla_moe":
        return {"ln1": zeros(), "attn": init_mla(gen, cfg, dtype), "ln2": zeros(),
                "moe": init_moe_share(gen, cfg, dtype)}
    if kind == "mla_dense":
        return {"ln1": zeros(), "attn": init_mla(gen, cfg, dtype), "ln2": zeros(),
                "mlp": init_mlp(gen, cfg, dtype, d_ff=_ffn_width(kind, cfg))}
    if kind == "attn_moe":
        return {"ln1": zeros(), "attn": init_attention(gen, cfg, dtype), "ln2": zeros(),
                "moe": init_moe(gen, cfg, dtype)}
    if kind in ATTN_KINDS:
        return {"ln1": zeros(), "attn": init_attention(gen, cfg, dtype), "ln2": zeros(),
                "mlp": init_mlp(gen, cfg, dtype, d_ff=_ffn_width(kind, cfg))}
    init = {"mamba2": init_mamba2, "mlstm": init_mlstm, "slstm": init_slstm}[kind]
    return {"ln": zeros(), _RECURRENT[kind][2]: init(gen, cfg, dtype)}


def _block(kind, p, x, cfg, want_cache=False):
    """One block over the full sequence. Returns ``(x, cache entry, aux)``:
    the entry is ``{"k", "v"}`` for the attention kinds, the final state
    for the recurrent ones; ``aux`` is the MoE load-balance loss, else None.
    ``want_cache`` (prefill, no gradient) routes attention through the
    flash kernel and the Mamba-2 scan through ssd_scan."""
    eps = cfg.norm_eps
    if kind == "moe":
        h, _ = moe_share_block(p["moe"], rms_norm(x, p["ln"], eps), cfg)
        return x + _residual(h), {}, None
    if kind == "attn":
        h, (k, v) = attention_block(p["attn"], rms_norm(x, p["ln"], eps), cfg,
                                    want_cache=want_cache)
        return x + _residual(h), {"k": k, "v": v}, None
    if kind in MLA_KINDS:
        h = mla_block(p["attn"], rms_norm(x, p["ln1"], eps), cfg, want_cache=want_cache)
        x = x + _residual(h)
        hn = rms_norm(x, p["ln2"], eps)
        h = moe_share_block(p["moe"], hn, cfg)[0] if kind == "mla_moe" else mlp_block(
            p["mlp"], hn)
        return x + _residual(h), {}, None
    if kind in ATTN_KINDS:
        h, (k, v) = attention_block(p["attn"], rms_norm(x, p["ln1"], eps), cfg,
                                    want_cache=want_cache)
        x = x + _residual(h)
        hn = rms_norm(x, p["ln2"], eps)
        if kind == "attn_moe":
            moe_fn = moe_block_a2a if cfg.moe_impl == "a2a" else moe_block
            h, aux = moe_fn(p["moe"], hn, cfg)
        else:
            h, aux = mlp_block(p["mlp"], hn), None
        return x + _residual(h), {"k": k, "v": v}, aux
    fn, _, key = _RECURRENT[kind]
    kw = {"want_cache": want_cache} if kind == "mamba2" else {}
    h, st = fn(p[key], rms_norm(x, p["ln"], eps), cfg, **kw)
    return x + _residual(h), st, None


def _residual(h):
    """A sublayer's output as the residual stream is sharded (a port-only
    site). On DTensors the row-split output projection leaves a partial
    sum, which DTensor, propagating op by op, would carry into the next
    norm and matmul (gathering that matmul's weights) where GSPMD reduces
    it: the Megatron all-reduce (reduce-scatter with ``seq_parallel``)."""
    return shard(h, "batch", "seq_act", "embed_act")


def _recompute_context():
    """A checkpoint's contexts: none for the forward, and for the recompute
    the span that the moe layers' rows counters do not count."""
    return contextlib.nullcontext(), recomputing()


def _train_block(kind, p, x, cfg):
    x, _, aux = _block(kind, p, x, cfg)
    return x, aux


def _decode_block(kind, p, x, cache, cache_pos, cfg):
    """One token through one block against its cache entry (updated in
    place); ``cache_pos`` a 0-d int32 tensor on the device. Returns x. An
    ``attn_moe`` layer routes the token through ``moe_block`` and drops its
    aux, as the reference does; a ``moe`` layer holds no cache."""
    eps = cfg.norm_eps
    if kind == "moe":
        return x + moe_share_block(p["moe"], rms_norm(x, p["ln"], eps), cfg)[0]
    if kind in MLA_KINDS:
        raise NotImplementedError("multi-head latent attention has no latent cache in the "
                                  "port: decode is not supported")
    if kind == "attn":
        return x + decode_attention_block(
            p["attn"], rms_norm(x, p["ln"], eps), cache["k"], cache["v"], cache_pos, cfg,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
    if kind in ATTN_KINDS:
        x = x + decode_attention_block(
            p["attn"], rms_norm(x, p["ln1"], eps), cache["k"], cache["v"], cache_pos, cfg,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
        hn = rms_norm(x, p["ln2"], eps)
        if kind == "attn_moe":
            return x + moe_block(p["moe"], hn, cfg)[0]
        return x + mlp_block(p["mlp"], hn)
    _, fn, key = _RECURRENT[kind]
    h, _ = fn(p[key], rms_norm(x, p["ln"], eps), cache, cfg)
    return x + h


def _cache_shapes(kind, cfg, batch, max_len, cdt) -> dict:
    """{leaf: (shape, dtype)} for one block's decode cache entry. KV caches
    live in the compute dtype, or int8 with bf16 per-(token, head) scales;
    a windowed config keeps only ``min(max_len, window)`` slots. The
    recurrent states (SSM, mLSTM, sLSTM) are f32, since they integrate over
    the whole sequence; the Mamba-2 conv context is in the compute dtype."""
    f32 = torch.float32
    if kind == "moe":
        return {}
    if kind in MLA_KINDS:
        raise NotImplementedError("multi-head latent attention has no latent (c_kv, k_pe) "
                                  "cache in the port")
    if kind == "mamba2":
        shp = mamba2_state_shape(cfg, batch)
        return {"ssm": (shp["ssm"], f32), "conv": (shp["conv"], cdt)}
    if kind in ("mlstm", "slstm"):
        fn = mlstm_state_shape if kind == "mlstm" else slstm_state_shape
        return {name: (shape, f32) for name, shape in fn(cfg, batch).items()}
    s = min(max_len, cfg.window) if cfg.window else max_len
    shp = (batch, s, cfg.num_kv_heads, cfg.head_dim_)
    if cfg.kv_cache_dtype == "int8":
        sshp = (batch, s, cfg.num_kv_heads, 1)
        return {"k": (shp, torch.int8), "k_scale": (sshp, torch.bfloat16),
                "v": (shp, torch.int8), "v_scale": (sshp, torch.bfloat16)}
    return {"k": (shp, cdt), "v": (shp, cdt)}


def _cache_leaf_axes(kind, cfg) -> dict:
    """{leaf: logical axes} of one block's decode cache entry (the
    reference's ``_cache_shapes`` axes), the tree of :func:`_cache_shapes`."""
    if kind == "moe":
        return {}
    if kind in MLA_KINDS:
        raise NotImplementedError("multi-head latent attention has no latent (c_kv, k_pe) "
                                  "cache in the port")
    if kind == "mamba2":
        return {"ssm": ("batch", "inner_heads", None, None), "conv": ("batch", None, "inner_flat")}
    if kind == "mlstm":
        return {"C": ("batch", "inner_heads", None, None), "n": ("batch", "inner_heads", None)}
    if kind == "slstm":
        return {name: ("batch", "embed_state") for name in slstm_state_shape(cfg, 1)}
    ax = ("batch", None, "kv_heads", None)
    names = ("k", "k_scale", "v", "v_scale") if cfg.kv_cache_dtype == "int8" else ("k", "v")
    return {name: ax for name in names}


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _unflatten(flat: dict) -> dict:
    """{"a/b": leaf} -> {"a": {"b": leaf}} (the inverse of ``flatten_tree``)."""
    out: dict = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = leaf
    return out


class _Tree(nn.Module):
    """A subtree of parameters: its leaves are parameters, its subtrees
    modules, so the state-dict names are the tree paths. ``tree[name]``
    reads a child, as a dict would."""

    def __init__(self, shapes: dict | None = None, lead=(), dtype=None, device=None):
        super().__init__()
        for name, shape in (shapes or {}).items():
            if isinstance(shape, dict):
                self.add_module(name, _Tree(shape, lead, dtype, device))
            else:
                self.register_parameter(name, nn.Parameter(
                    torch.empty((*lead, *shape), dtype=dtype, device=device)))

    def __getitem__(self, name):
        return getattr(self, name)

    def values(self) -> dict:
        out = dict(self.named_parameters(recurse=False))
        out.update({name: child.values() for name, child in self.named_children()})
        return out


class _Segment(_Tree):
    """``count`` blocks of one kind, every leaf stacked on a leading layers
    axis; ``count=None`` is one unstacked block (zamba2's shared block).
    The stacked per-head and per-channel leaves (Mamba-2's ``A_log``,
    ``D``, ..., the mLSTM's ``b_f``) are rank 2, so AdamW decays them, as
    in the reference."""

    def __init__(self, kind: str, count: int | None, cfg: ModelConfig, dtype, device):
        super().__init__(_block_shapes(kind, cfg), () if count is None else (count,),
                         dtype, device)
        self.kind, self.count = kind, count

    def layers(self) -> list[dict]:
        """Per-layer views of the stacked leaves (``unbind(0)``)."""
        views = {path: p.unbind(0) for path, p in flatten_tree(self.values()).items()}
        return [_unflatten({path: v[i] for path, v in views.items()})
                for i in range(self.count)]

    @torch.no_grad()
    def init(self, gen, cfg, dtype) -> None:
        """Per-layer draws in the reference's order, written into each
        layer's slice (an unstacked block is one draw)."""
        leaves = flatten_tree(self.values())
        for i in range(self.count or 1):
            block = flatten_tree(_init_block(self.kind, gen, cfg, dtype))
            for path, p in leaves.items():
                (p if self.count is None else p[i]).copy_(block[path])


class Model(nn.Module):
    """The decoder of any registered family. Parameters are allocated on
    ``device`` but not initialised: call :meth:`init` (or load weights
    through :mod:`repro_torch.models.convert` / a checkpoint) before use,
    as the reference's ``Model(cfg)`` holds no parameters until ``init``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        kinds = [kind for kind, _ in cfg.segments()]
        self.cfg = cfg
        self.device = resolve_device(device)
        dtype = _dtype(cfg.param_dtype)
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(torch.empty((v, d), dtype=dtype, device=self.device))
        self.final_norm = nn.Parameter(torch.empty((d,), dtype=dtype, device=self.device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.empty((d, v), dtype=dtype, device=self.device)
            )
        if cfg.frontend != "none":
            self.frontend = nn.Parameter(
                torch.empty((cfg.frontend_dim, d), dtype=dtype, device=self.device)
            )
        self.segments = nn.ModuleList(
            _Tree() if kind == "shared_attn" else _Segment(kind, count, cfg, dtype, self.device)
            for kind, count in cfg.segments()
        )
        self.shared_attn = None
        if "shared_attn" in kinds:
            self.shared_attn = _Segment("shared_attn", None, cfg, dtype, self.device)
        n_moe = 0  # each expert-share segment's first row of the buffers below
        for (kind, count), seg in zip(cfg.segments(), self.segments):
            if kind in SHARE_KINDS:
                seg.moe_first, n_moe = n_moe, n_moe + count
        if n_moe:
            self.register_buffer("router_bias", torch.zeros(
                (n_moe, cfg.moe_routed), dtype=torch.float32, device=self.device))
            self.register_buffer("expert_rows", torch.zeros(
                (n_moe, cfg.moe_num_experts), dtype=torch.int64, device=self.device),
                persistent=False)

    # ------------------------------------------------------------- init
    @torch.no_grad()
    def init(self, seed: int = 0) -> "Model":
        """Fill every parameter from a ``torch.Generator`` seeded ``seed``
        (the reference's distributions; not its PRNG bits)."""
        cfg = self.cfg
        dtype = _dtype(cfg.param_dtype)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        d, v = cfg.d_model, cfg.vocab_size
        self.embed.copy_(normal_init(gen, (v, d), dtype))
        self.final_norm.zero_()
        if not cfg.tie_embeddings:
            self.lm_head.copy_(
                (torch.randn((d, v), generator=gen, device=self.device) / d**0.5).to(dtype)
            )
        if cfg.frontend != "none":
            self.frontend.copy_(
                (torch.randn((cfg.frontend_dim, d), generator=gen, device=self.device)
                 / cfg.frontend_dim**0.5).to(dtype)
            )
        shared_drawn = False
        for (kind, _), seg in zip(cfg.segments(), self.segments):
            if kind != "shared_attn":
                seg.init(gen, cfg, dtype)
            elif not shared_drawn:  # drawn at its first site, as the reference
                self.shared_attn.init(gen, cfg, dtype)
                shared_drawn = True
        return self

    def values(self) -> dict:
        """The reference's values tree over this model's parameters."""
        out = {"embed": self.embed, "final_norm": self.final_norm,
               "segments": [seg.values() for seg in self.segments]}
        if not self.cfg.tie_embeddings:
            out["lm_head"] = self.lm_head
        if self.cfg.frontend != "none":
            out["frontend"] = self.frontend
        if self.shared_attn is not None:
            out["shared_attn"] = self.shared_attn.values()
        return out

    def param_axes(self) -> dict:
        """{path: logical axes} of every parameter, keyed like
        ``flatten_tree(self.values())`` (the reference's tree paths), each
        stacked leaf with a leading "layers" axis."""
        cfg = self.cfg
        out = {"embed": ("vocab", "embed"), "final_norm": ("embed",)}
        if not cfg.tie_embeddings:
            out["lm_head"] = ("embed", "vocab")
        if cfg.frontend != "none":
            out["frontend"] = (None, "embed")
        for i, (kind, count) in enumerate(cfg.segments()):
            if kind == "shared_attn":
                continue
            for path, ax in flatten_tree(_block_axes(kind, cfg), "", is_leaf=_is_axes).items():
                out[f"segments/{i}/{path}"] = ("layers", *ax)
        if self.shared_attn is not None:
            for path, ax in flatten_tree(_block_axes("shared_attn", cfg), "",
                                         is_leaf=_is_axes).items():
                out[f"shared_attn/{path}"] = ax
        return out

    def device_counters(self) -> dict:
        """The counters the model accumulates on its device, by name:
        ``moe.expert_rows`` (moe layers, held experts) int64, the rows each
        training step routed to each held expert, counted once a step. A
        tracer reads them around each step (``train.step``'s ``counters``)."""
        return {"moe.expert_rows": self.expert_rows} if hasattr(self, "expert_rows") else {}

    def _layers(self, kind, seg) -> list:
        """``seg``'s per-layer trees; a ``moe`` segment's with each layer's
        correction bias and rows counter, rows of the model's buffers."""
        layers = seg.layers()
        if kind in SHARE_KINDS:
            for i, lp in enumerate(layers, seg.moe_first):
                lp["moe"].update(bias=self.router_bias[i], rows=self.expert_rows[i])
        return layers

    # ---------------------------------------------------------- forward
    def _embed_tokens(self, tokens):
        return F.embedding(tokens, self.embed).to(_dtype(self.cfg.compute_dtype))

    def _embed_inputs(self, inputs):
        """The decoder's input rows: tokens embedded, after the projected
        patches (``patch``), or the projected frames alone (``frame``)."""
        frontend = self.cfg.frontend
        if frontend == "frame":
            cdt = _dtype(self.cfg.compute_dtype)
            return shard(inputs["frames"].to(cdt) @ self.frontend.to(cdt),
                         "batch", None, "embed_act")
        x = self._embed_tokens(inputs["tokens"])
        if frontend == "patch":
            pe = inputs["patch_embeds"].to(x.dtype) @ self.frontend.to(x.dtype)
            x = torch.cat([pe, x], dim=1)
        return shard(x, "batch", None, "embed_act")

    def _logits(self, x):
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return shard(x @ head.to(x.dtype), "batch", None, "vocab")

    def forward(self, inputs: dict, *, remat: str = "none", want_cache: bool = False):
        """Full-sequence pass over ``inputs["tokens"]`` (B, S) int, after
        ``inputs["patch_embeds"]`` (B, P, frontend_dim) for a ``patch``
        frontend, or over ``inputs["frames"]`` (B, S, frontend_dim) alone for
        a ``frame`` one.

        Returns ``(logits (B, S, V), aux)``; ``aux`` is the f32 sum of the
        ``attn_moe`` layers' load-balance losses, in layer order (zero
        without MoE layers), as the reference's. With ``want_cache``
        (prefill: no gradient, attention in the flash kernel, the Mamba-2
        scan in the ssd_scan kernel) returns ``(logits, aux, caches)``, one
        entry per segment: ``{"k", "v"}`` stacks (L, B, S, KVH, D) for the
        attention kinds, the recurrent kinds' final states stacked on L
        (``{"ssm", "conv"}``, ``{"C", "n"}``, ``{"c", "n", "h", "m"}``), and
        an unstacked ``{"k", "v"}`` (B, S, KVH, D) for a shared_attn site,
        as the reference's forward gives.
        """
        if remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")
        cfg = self.cfg
        x = self._embed_inputs(inputs)
        ckpt = remat != "none" and torch.is_grad_enabled() and not want_cache
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = []
        for (kind, _), seg in zip(cfg.segments(), self.segments):
            if kind == "shared_attn":  # applied outside the layer scan: no remat
                x, entry, _ = _block(kind, self.shared_attn.values(), x, cfg, want_cache)
                caches.append(entry)
                continue
            entries = []
            for lp in self._layers(kind, seg):
                if ckpt:
                    # The block draws no random numbers: no RNG state to
                    # keep, and a CUDA graph's capture may not read it.
                    x, aux = checkpoint(_train_block, kind, lp, x, cfg, use_reentrant=False,
                                        preserve_rng_state=False, context_fn=_recompute_context)
                else:
                    x, entry, aux = _block(kind, lp, x, cfg, want_cache)
                    entries.append(entry)
                # Megatron-SP: with run_cfg.seq_parallel the "seq_act" rule
                # maps to "model" and the residual stream lives sequence-
                # sharded between blocks.
                x = shard(x, "batch", "seq_act", "embed_act")
                if aux is not None:
                    aux_total = aux_total + aux
            if want_cache:
                caches.append({name: torch.stack([e[name] for e in entries])
                               for name in entries[0]})
        if want_cache:
            return self._logits(x), aux_total, caches
        return self._logits(x), aux_total

    # ------------------------------------------------------------ decode
    def cache_specs(self, batch: int, max_len: int, dtype=None) -> list[dict]:
        """Per segment, ``{leaf: (shape, dtype)}`` of the decode cache, each
        shape with the segment's leading layers axis (1 for a shared_attn
        site, which holds its own KV)."""
        cdt = dtype or _dtype(self.cfg.compute_dtype)
        out = []
        for kind, count in self.cfg.segments():
            lead = 1 if kind == "shared_attn" else count
            shapes = _cache_shapes(kind, self.cfg, batch, max_len, cdt)
            out.append({name: ((lead, *shape), dt) for name, (shape, dt) in shapes.items()})
        return out

    def cache_axes(self, batch: int, max_len: int, tp: int | None = None) -> list[dict]:
        """Logical axes of every cache leaf, the structure of ``cache_specs``
        (each with the leading "layers" axis).

        When the KV-head count does not divide the tensor-parallel degree
        (starcoder2/tinyllama: kv=4 vs tp=16), KV caches shard on the
        *sequence* dim instead ("kv_seq" -> model), flash-decoding-style
        split-K, as the reference's.
        """
        split_k = tp is not None and self.cfg.num_kv_heads % tp != 0
        out = []
        for kind, _ in self.cfg.segments():
            axes = _cache_leaf_axes(kind, self.cfg)
            if split_k and kind in ATTN_KINDS:
                axes = {name: ("batch", "kv_seq", None, None) for name in axes}
            out.append({name: ("layers", *ax) for name, ax in axes.items()})
        return out

    def init_cache(self, batch: int, max_len: int, dtype=None) -> list[dict]:
        """Zero decode cache on the model's device (mirrors the segments)."""
        return [
            {name: torch.zeros(shape, dtype=dt, device=self.device)
             for name, (shape, dt) in spec.items()}
            for spec in self.cache_specs(batch, max_len, dtype)
        ]

    def decode_step(self, caches: list[dict], tokens, cache_pos):
        """One token for the whole batch. ``tokens`` (B, 1) int; ``cache_pos``
        the absolute position of that token, a 0-d int32 tensor on the
        model's device (a Python int is made one), as the reference's traced
        ``jnp.int32``. Updates ``caches`` in place and returns ``(logits (B,
        1, V), caches)``. Reads nothing back to the host, so one step can be
        captured in a CUDA graph (``train_step.build_decode_step``)."""
        cfg = self.cfg
        cache_pos = position(cache_pos, self.device)
        # a port-only site, as forward's: a vocab-sharded lookup resolved here
        x = shard(self._embed_tokens(tokens), "batch", None, "embed_act")
        for (kind, _), seg, cache in zip(cfg.segments(), self.segments, caches):
            if kind == "shared_attn":
                x = _decode_block(kind, self.shared_attn.values(), x,
                                  {k: t[0] for k, t in cache.items()}, cache_pos, cfg)
                continue
            for i, lp in enumerate(self._layers(kind, seg)):
                x = _decode_block(kind, lp, x, {k: t[i] for k, t in cache.items()},
                                  cache_pos, cfg)
        return self._logits(x), caches


def build_model(cfg: ModelConfig, *, device=None) -> Model:
    return Model(cfg, device=device)
