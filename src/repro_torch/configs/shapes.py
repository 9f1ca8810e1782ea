"""The assigned input-shape set (same four cells for every LM-family arch).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of seq_len), NOT ``train_step``; ``prefill_*`` lowers the full-sequence
forward that builds the cache. Skips (assignment-mandated):
* long_500k  -> only archs with a sub-quadratic path (hybrid/ssm families);
* decode_*   -> not for encoder-only archs.
"""

from __future__ import annotations

from .base import ModelConfig, ShapeConfig

__all__ = ["SHAPES", "get_shape", "cell_status"]

SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cell_status(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """'run' or a skip reason for the (arch x shape) dry-run cell."""
    if shape.kind == "decode" and not cfg.supports_decode():
        return "skip: encoder-only arch has no autoregressive step"
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return "skip: pure full-attention arch (assignment: sub-quadratic only)"
    return "run"
