"""SwiGLU MLP (LLaMA-style gated feed-forward; ``repro/models/mlp.py``)."""

from __future__ import annotations

import torch.nn.functional as F

from ..parallel.axes import shard
from .common import scaled_init

__all__ = ["init_mlp", "mlp_block"]


def init_mlp(gen, cfg, dtype, d_ff=None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "wi_gate": scaled_init(gen, (d, f), dtype),
        "wi_up": scaled_init(gen, (d, f), dtype),
        "wo": scaled_init(gen, (f, d), dtype, fan_in=f),
    }


def mlp_block(p, x):
    h = F.silu(x @ p["wi_gate"])
    h = h * (x @ p["wi_up"])
    h = shard(h, "batch", None, "mlp")
    return h @ p["wo"]
