"""Config registry: ``--arch <id>`` resolves through here."""

from __future__ import annotations

import dataclasses

from .base import ModelConfig, RunConfig, ShapeConfig
from .shapes import SHAPES, cell_status, get_shape

from . import (  # noqa: E402
    deepseek_7b,
    deepseek_moe_16b,
    hubert_xlarge,
    kimi_k2_1t_a32b,
    kimi_k2_instruct,
    llava_next_34b,
    nemotron_3_nano_30b_a3b,
    phi3_medium_14b,
    starcoder2_15b,
    tinyllama_1_1b,
    xlstm_350m,
    zamba2_1_2b,
)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        starcoder2_15b,
        deepseek_7b,
        phi3_medium_14b,
        tinyllama_1_1b,
        zamba2_1_2b,
        deepseek_moe_16b,
        kimi_k2_1t_a32b,
        llava_next_34b,
        hubert_xlarge,
        xlstm_350m,
        nemotron_3_nano_30b_a3b,
        kimi_k2_instruct,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return list(ARCHS)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Small same-family variant for CPU smoke tests (assignment: reduced
    configs exercise real compute; full configs only via the dry-run)."""
    kw: dict = dict(
        num_layers=4 if cfg.family in ("hybrid", "ssm") else 2,
        d_model=128,
        num_heads=4,
        num_kv_heads=cfg.num_kv_heads if cfg.num_kv_heads == cfg.num_heads else 2,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=32,
        attn_chunk=64,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.num_kv_heads == cfg.num_heads:
        kw["num_kv_heads"] = 4
    if cfg.moe_num_experts:
        kw.update(
            moe_num_experts=8,
            moe_top_k=2,
            moe_num_shared=min(cfg.moe_num_shared, 1),
            moe_first_dense=min(cfg.moe_first_dense, 1),
            moe_dense_ff=320 if cfg.moe_dense_ff else 0,
        )
    if cfg.family == "hybrid":
        kw.update(ssm_state=16, ssm_head_dim=32, attn_every=2)
    if cfg.family == "ssm":
        kw.update(slstm_every=2)
    if cfg.family == "nemotron_h":
        # the pattern's opening "MEMEM*": every kind; experts a quarter held
        kw.update(num_layers=6, num_kv_heads=2, d_ff=96, moe_num_experts=4,
                  moe_router_experts=16, moe_top_k=4, moe_shared_ff=192, ssm_state=16,
                  ssm_heads=8, ssm_head_dim=16, ssm_groups=2, ssm_chunk=16)
    if cfg.family == "mla_moe":
        # a dense layer then two moe layers; both latents, both halves of a
        # head; 2 experts held of 8 routed
        kw.update(num_layers=3, num_kv_heads=4, head_dim=24, d_ff=32, moe_num_experts=2,
                  moe_router_experts=8, moe_shared_ff=32, q_lora_rank=48, kv_lora_rank=32,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    if cfg.window:
        kw["window"] = 64
    if cfg.frontend != "none":
        kw.update(frontend_dim=32, frontend_len=8)
    return dataclasses.replace(cfg, **kw)


__all__ = [
    "ARCHS",
    "ModelConfig",
    "RunConfig",
    "SHAPES",
    "ShapeConfig",
    "cell_status",
    "get_config",
    "get_shape",
    "list_archs",
    "reduced",
]
