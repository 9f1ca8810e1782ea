"""Model assembly: dense and hybrid decoders (``repro/models/transformer.py``).

The parameter tree is the reference's: each segment's per-layer leaves are
stacked on a leading layers axis (``(L, d)`` norms, ``(L, in, out)``
weights), so the state-dict names are the reference tree paths with ``.``
for ``/`` (``segments.0.attn.wq`` is ``segments/0/attn/wq``), and
``values()`` returns the reference's nested tree of these parameters.
That matters beyond naming: AdamW decays every tensor of rank >= 2, so
the stacked ``(L, d)`` norm scales are decayed, as in the reference.

The reference scans a segment with ``lax.scan``; here a Python loop walks
the layers of ``unbind(0)`` views (one stacked gradient per leaf on the
way back). ``remat="dots"`` / ``"full"`` checkpoint each layer with
``torch.utils.checkpoint`` (non-reentrant): only the layer inputs are
kept, and the attention logits are recomputed in the backward pass.

Serving mirrors the reference: ``forward(..., want_cache=True)`` (prefill,
attention through the flash-attention kernel) also returns each segment's
``{"k", "v"}`` stacks (L, B, S, KVH, D); ``cache_specs`` / ``init_cache``
give the decode cache, stacked per segment like the parameters (rotating
window buffers when ``cfg.window`` is set, int8 with bf16 scales when
``cfg.kv_cache_dtype == "int8"``); ``decode_step`` runs one token through
every layer against it (attention through the decode-attention kernel),
updating it in place.

The hybrid family (zamba2) is ported too: ``mamba2`` segments stack their
leaves like any other (``ln (L, d)``, ``mixer.in_proj (L, d, e)``, ...),
and zamba2's *shared* attention+MLP block is one unstacked parameter set
under ``shared_attn``, applied at every ``shared_attn`` site, whose
``segments`` entry is an empty placeholder, the reference's tree. In the
prefill the Mamba-2 scan runs in the ``ssd_scan`` kernel and the shared
block's attention in the flash kernel; the cache holds ``{"ssm", "conv"}``
per Mamba segment (f32 SSM state, conv context in the compute dtype) and a
``{"k", "v"}`` of leading axis 1 per shared site, each site its own KV.

The attn_mlp, mamba2 and shared_attn block kinds without a frontend are
ported; the other kinds and the frontends raise and wait for later slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels.common import resolve_device
from .attention import attention_block, decode_attention_block, init_attention
from .common import normal_init, rms_norm
from .mamba2 import init_mamba2, mamba2_block, mamba2_decode, mamba2_state_shape
from .mlp import init_mlp, mlp_block

__all__ = ["Model", "build_model"]

#: Where each block kind that is not ported yet is queued (ROADMAP.md §1).
_NOT_PORTED = {
    "attn_dense_moe": "ROADMAP.md §1 item 3 (MoE)",
    "attn_moe": "ROADMAP.md §1 item 3 (MoE)",
    "mlstm": "ROADMAP.md §1 item 4 (xLSTM)",
    "slstm": "ROADMAP.md §1 item 4 (xLSTM)",
}
_PORTED = ("attn_mlp", "mamba2", "shared_attn")
REMAT_MODES = ("none", "dots", "full")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _attn_mlp_block(p, x, cfg):
    h, _ = attention_block(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg)
    x = x + h
    return x + mlp_block(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))


def _prefill_block(p, x, cfg):
    """``_attn_mlp_block`` through the flash kernel; also returns (k, v)."""
    h, kv = attention_block(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                            want_cache=True)
    x = x + h
    return x + mlp_block(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps)), kv


def _decode_block(p, x, cache, cache_pos, cfg):
    """One-token ``attn_mlp`` block against one layer's cache (updated in
    place). Returns x."""
    h = decode_attention_block(
        p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), cache["k"], cache["v"],
        cache_pos, cfg, k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
    )
    x = x + h
    return x + mlp_block(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))


def _mamba2_block(p, x, cfg, want_cache=False):
    """The pre-norm residual Mamba-2 block. Returns (x, {"ssm", "conv"})."""
    h, st = mamba2_block(p["mixer"], rms_norm(x, p["ln"], cfg.norm_eps), cfg,
                         want_cache=want_cache)
    return x + h, st


def _mamba2_train_block(p, x, cfg):
    return _mamba2_block(p, x, cfg)[0]


def _cache_shapes(kind, cfg, batch, max_len, cdt) -> dict:
    """{leaf: (shape, dtype)} for one block's decode cache entry. KV caches
    live in the compute dtype, or int8 with bf16 per-(token, head) scales;
    a windowed config keeps only ``min(max_len, window)`` slots. The
    Mamba-2 state is f32 (it integrates over the whole sequence), its conv
    context in the compute dtype."""
    if kind == "mamba2":
        shp = mamba2_state_shape(cfg, batch)
        return {"ssm": (shp["ssm"], torch.float32), "conv": (shp["conv"], cdt)}
    s = min(max_len, cfg.window) if cfg.window else max_len
    shp = (batch, s, cfg.num_kv_heads, cfg.head_dim_)
    if cfg.kv_cache_dtype == "int8":
        sshp = (batch, s, cfg.num_kv_heads, 1)
        return {"k": (shp, torch.int8), "k_scale": (sshp, torch.bfloat16),
                "v": (shp, torch.int8), "v_scale": (sshp, torch.bfloat16)}
    return {"k": (shp, cdt), "v": (shp, cdt)}


class _AttnMlpSegment(nn.Module):
    """``count`` attn_mlp blocks, every leaf stacked on a leading layers
    axis; ``count=None`` is one unstacked block (zamba2's shared block)."""

    def __init__(self, count: int | None, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim_
        h, kvh, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
        lead = () if count is None else (count,)

        def empty(*shape):
            return nn.Parameter(torch.empty((*lead, *shape), dtype=dtype, device=device))

        self.count = count
        self.ln1 = empty(d)
        self.attn = nn.ParameterDict({
            "wq": empty(d, h * hd), "wk": empty(d, kvh * hd),
            "wv": empty(d, kvh * hd), "wo": empty(h * hd, d),
        })
        self.ln2 = empty(d)
        self.mlp = nn.ParameterDict({
            "wi_gate": empty(d, f), "wi_up": empty(d, f), "wo": empty(f, d),
        })

    def values(self) -> dict:
        return {"attn": dict(self.attn), "ln1": self.ln1, "ln2": self.ln2,
                "mlp": dict(self.mlp)}

    def layers(self) -> list[dict]:
        """Per-layer views of the stacked leaves (``unbind(0)``)."""
        ln1, ln2 = self.ln1.unbind(0), self.ln2.unbind(0)
        attn = {k: v.unbind(0) for k, v in self.attn.items()}
        mlp = {k: v.unbind(0) for k, v in self.mlp.items()}
        return [
            {"ln1": ln1[i], "ln2": ln2[i],
             "attn": {k: v[i] for k, v in attn.items()},
             "mlp": {k: v[i] for k, v in mlp.items()}}
            for i in range(self.count)
        ]

    @torch.no_grad()
    def init(self, gen, cfg, dtype) -> None:
        # Per-layer draws in the reference's order (attn then mlp), stacked.
        # An unstacked block is one draw, its stack viewed without the axis.
        blocks = [(init_attention(gen, cfg, dtype), init_mlp(gen, cfg, dtype))
                  for _ in range(self.count or 1)]
        self.ln1.zero_()
        self.ln2.zero_()
        for k, p in self.attn.items():
            p.copy_(torch.stack([a[k] for a, _ in blocks]).view_as(p))
        for k, p in self.mlp.items():
            p.copy_(torch.stack([m[k] for _, m in blocks]).view_as(p))


class _Mamba2Segment(nn.Module):
    """``count`` mamba2 blocks, every leaf stacked on a leading layers axis.

    The per-head and per-channel leaves (``A_log``, ``dt_bias``, ``D``,
    ``conv_b``) stack to rank 2, so AdamW decays them, as in the reference.
    """

    def __init__(self, count: int, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, k = cfg.d_model, cfg.ssm_conv
        di, n = cfg.d_inner, cfg.ssm_state
        heads = di // cfg.ssm_head_dim
        conv_dim = di + 2 * n

        def empty(*shape):
            return nn.Parameter(torch.empty((count, *shape), dtype=dtype, device=device))

        self.count = count
        self.ln = empty(d)
        self.mixer = nn.ParameterDict({
            "in_proj": empty(d, 2 * di + 2 * n + heads), "conv_w": empty(k, conv_dim),
            "conv_b": empty(conv_dim), "A_log": empty(heads), "dt_bias": empty(heads),
            "D": empty(heads), "out_proj": empty(di, d),
        })

    def values(self) -> dict:
        return {"ln": self.ln, "mixer": dict(self.mixer)}

    def layers(self) -> list[dict]:
        """Per-layer views of the stacked leaves (``unbind(0)``)."""
        ln = self.ln.unbind(0)
        mixer = {k: v.unbind(0) for k, v in self.mixer.items()}
        return [{"ln": ln[i], "mixer": {k: v[i] for k, v in mixer.items()}}
                for i in range(self.count)]

    @torch.no_grad()
    def init(self, gen, cfg, dtype) -> None:
        blocks = [init_mamba2(gen, cfg, dtype) for _ in range(self.count)]
        self.ln.zero_()
        for k, p in self.mixer.items():
            p.copy_(torch.stack([b[k] for b in blocks]))


class _SharedSite(nn.Module):
    """A ``shared_attn`` site: no parameters of its own (they live in
    ``Model.shared_attn``); its values are the reference's ``{}``."""

    def values(self) -> dict:
        return {}


class Model(nn.Module):
    """Dense or hybrid decoder. Parameters are allocated on
    ``device`` but not initialised: call :meth:`init` (or load weights
    through :mod:`repro_torch.models.convert` / a checkpoint) before use,
    as the reference's ``Model(cfg)`` holds no parameters until ``init``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        for kind, _ in cfg.segments():
            if kind not in _PORTED:
                raise NotImplementedError(
                    f"{cfg.name}: block kind {kind!r} is not ported yet: "
                    f"{_NOT_PORTED.get(kind, 'ROADMAP.md §1')}"
                )
        if cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.frontend!r} frontend stub is not ported "
                "yet: ROADMAP.md §1 item 5 (dense-family remainder)"
            )
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
        segs = []
        for kind, count in cfg.segments():
            if kind == "attn_mlp":
                segs.append(_AttnMlpSegment(count, cfg, dtype, self.device))
            elif kind == "mamba2":
                segs.append(_Mamba2Segment(count, cfg, dtype, self.device))
            else:
                segs.append(_SharedSite())
        self.segments = nn.ModuleList(segs)
        self.shared_attn = None
        if any(kind == "shared_attn" for kind, _ in cfg.segments()):
            self.shared_attn = _AttnMlpSegment(None, cfg, dtype, self.device)

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
        if self.shared_attn is not None:
            out["shared_attn"] = self.shared_attn.values()
        return out

    # ---------------------------------------------------------- forward
    def _embed_inputs(self, inputs):
        cdt = _dtype(self.cfg.compute_dtype)
        return F.embedding(inputs["tokens"], self.embed).to(cdt)

    def _logits(self, x):
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x @ head.to(x.dtype)

    def forward(self, inputs: dict, *, remat: str = "none", want_cache: bool = False):
        """Full-sequence pass over ``inputs["tokens"]`` (B, S) int.

        Returns ``(logits (B, S, V), aux)``; ``aux`` is the f32 zero the
        reference returns for blocks without an auxiliary loss. With
        ``want_cache`` (prefill: no gradient, attention in the flash
        kernel, the Mamba-2 scan in the ssd_scan kernel) returns ``(logits,
        aux, caches)``, one entry per segment: ``{"k", "v"}`` stacks (L, B,
        S, KVH, D) for attn_mlp, ``{"ssm", "conv"}`` stacks (L, B, H, P, N)
        and (L, B, K-1, C) for mamba2, and an unstacked ``{"k", "v"}`` (B, S,
        KVH, D) for a shared_attn site, as the reference's forward gives.
        """
        if remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")
        cfg = self.cfg
        x = self._embed_inputs(inputs)
        ckpt = remat != "none" and torch.is_grad_enabled()
        caches = []
        for (kind, _), seg in zip(cfg.segments(), self.segments):
            if kind == "shared_attn":  # applied outside the layer scan: no remat
                p = self.shared_attn.values()
                if want_cache:
                    x, (k, v) = _prefill_block(p, x, cfg)
                    caches.append({"k": k, "v": v})
                else:
                    x = _attn_mlp_block(p, x, cfg)
                continue
            block = _attn_mlp_block if kind == "attn_mlp" else _mamba2_train_block
            entries = []
            for lp in seg.layers():
                if want_cache:
                    if kind == "attn_mlp":
                        x, (k, v) = _prefill_block(lp, x, cfg)
                        entries.append({"k": k, "v": v})
                    else:
                        x, st = _mamba2_block(lp, x, cfg, want_cache=True)
                        entries.append(st)
                elif ckpt:
                    x = checkpoint(block, lp, x, cfg, use_reentrant=False)
                else:
                    x = block(lp, x, cfg)
            if want_cache:
                caches.append({name: torch.stack([e[name] for e in entries])
                               for name in entries[0]})
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if want_cache:
            return self._logits(x), aux, caches
        return self._logits(x), aux

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

    def init_cache(self, batch: int, max_len: int, dtype=None) -> list[dict]:
        """Zero decode cache on the model's device (mirrors the segments)."""
        return [
            {name: torch.zeros(shape, dtype=dt, device=self.device)
             for name, (shape, dt) in spec.items()}
            for spec in self.cache_specs(batch, max_len, dtype)
        ]

    def decode_step(self, caches: list[dict], tokens, cache_pos: int):
        """One token for the whole batch. ``tokens`` (B, 1) int; ``cache_pos``
        the absolute position of that token. Updates ``caches`` in place
        and returns ``(logits (B, 1, V), caches)``."""
        cfg = self.cfg
        x = self._embed_inputs({"tokens": tokens})
        for (kind, _), seg, cache in zip(cfg.segments(), self.segments, caches):
            if kind == "shared_attn":
                x = _decode_block(self.shared_attn.values(), x,
                                  {k: t[0] for k, t in cache.items()}, cache_pos, cfg)
                continue
            for i, lp in enumerate(seg.layers()):
                layer_cache = {k: t[i] for k, t in cache.items()}
                if kind == "mamba2":
                    h, _ = mamba2_decode(lp["mixer"], rms_norm(x, lp["ln"], cfg.norm_eps),
                                         layer_cache, cfg)
                    x = x + h
                else:
                    x = _decode_block(lp, x, layer_cache, cache_pos, cfg)
        return self._logits(x), caches


def build_model(cfg: ModelConfig, *, device=None) -> Model:
    return Model(cfg, device=device)
