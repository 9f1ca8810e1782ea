"""Model assembly for the dense decoder (``repro/models/transformer.py``).

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

Only the ``attn_mlp`` block kind without a frontend is ported; the other
kinds, frontends, and decode caches raise and wait for later slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels.common import resolve_device
from .attention import attention_block, init_attention
from .common import normal_init, rms_norm
from .mlp import init_mlp, mlp_block

__all__ = ["Model", "build_model"]

#: Where each block kind that is not ported yet is queued (ROADMAP.md §1).
_NOT_PORTED = {
    "shared_attn": "ROADMAP.md §1 item 3 (hybrid family)",
    "mamba2": "ROADMAP.md §1 item 3 (hybrid family)",
    "attn_dense_moe": "ROADMAP.md §1 item 4 (MoE)",
    "attn_moe": "ROADMAP.md §1 item 4 (MoE)",
    "mlstm": "ROADMAP.md §1 item 5 (xLSTM)",
    "slstm": "ROADMAP.md §1 item 5 (xLSTM)",
}
REMAT_MODES = ("none", "dots", "full")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _attn_mlp_block(p, x, cfg):
    h, _ = attention_block(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg)
    x = x + h
    return x + mlp_block(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))


class _AttnMlpSegment(nn.Module):
    """``count`` attn_mlp blocks, every leaf stacked on a leading layers axis."""

    def __init__(self, count: int, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim_
        h, kvh, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff

        def empty(*shape):
            return nn.Parameter(torch.empty((count, *shape), dtype=dtype, device=device))

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
        blocks = []
        for _ in range(self.count):
            attn = init_attention(gen, cfg, dtype)
            blocks.append((attn, init_mlp(gen, cfg, dtype)))
        self.ln1.zero_()
        self.ln2.zero_()
        for k, p in self.attn.items():
            p.copy_(torch.stack([a[k] for a, _ in blocks]))
        for k, p in self.mlp.items():
            p.copy_(torch.stack([m[k] for _, m in blocks]))


class Model(nn.Module):
    """Dense decoder (``attn_mlp`` blocks). Parameters are allocated on
    ``device`` but not initialised: call :meth:`init` (or load weights
    through :mod:`repro_torch.models.convert` / a checkpoint) before use,
    as the reference's ``Model(cfg)`` holds no parameters until ``init``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        for kind, _ in cfg.segments():
            if kind != "attn_mlp":
                raise NotImplementedError(
                    f"{cfg.name}: block kind {kind!r} is not ported yet: "
                    f"{_NOT_PORTED.get(kind, 'ROADMAP.md §1')}"
                )
        if cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.frontend!r} frontend stub is not ported "
                "yet: ROADMAP.md §1 item 6 (dense-family remainder)"
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
        self.segments = nn.ModuleList(
            _AttnMlpSegment(count, cfg, dtype, self.device) for _, count in cfg.segments()
        )

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
        for seg in self.segments:
            seg.init(gen, cfg, dtype)
        return self

    def values(self) -> dict:
        """The reference's values tree over this model's parameters."""
        out = {"embed": self.embed, "final_norm": self.final_norm,
               "segments": [seg.values() for seg in self.segments]}
        if not self.cfg.tie_embeddings:
            out["lm_head"] = self.lm_head
        return out

    # ---------------------------------------------------------- forward
    def _embed_inputs(self, inputs):
        cdt = _dtype(self.cfg.compute_dtype)
        return F.embedding(inputs["tokens"], self.embed).to(cdt)

    def _logits(self, x):
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x @ head.to(x.dtype)

    def forward(self, inputs: dict, *, remat: str = "none"):
        """Full-sequence pass over ``inputs["tokens"]`` (B, S) int.

        Returns ``(logits (B, S, V), aux)``; ``aux`` is the f32 zero the
        reference returns for blocks without an auxiliary loss.
        """
        if remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")
        cfg = self.cfg
        x = self._embed_inputs(inputs)
        ckpt = remat != "none" and torch.is_grad_enabled()
        for seg in self.segments:
            for lp in seg.layers():
                if ckpt:
                    x = checkpoint(_attn_mlp_block, lp, x, cfg, use_reentrant=False)
                else:
                    x = _attn_mlp_block(lp, x, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._logits(x), aux


def build_model(cfg: ModelConfig, *, device=None) -> Model:
    return Model(cfg, device=device)
