"""Kimi-K2-Instruct [hf: moonshotai/Kimi-K2-Instruct, config.json, model type
``kimi_k2``, DeepSeek-V3's layout] — 61 pre-norm layers at hidden 7168.

Every layer attends through multi-head latent attention: 64 heads, q from a
1536-wide latent and k / v from a 512-wide one (each RMS-normed), a head's
q and k 128 columns without rotary positions and 64 with them (one rotary
key shared by all heads), v 128 wide; YaRN (factor 32 over 4096, beta 1
and 1, mscale 1 and 1) on the rotary part, theta 50,000, so the softmax
scale is 192^-0.5 (0.1 ln 32 + 1)^2. Layer 0 has a dense SwiGLU of 18,432
(``first_k_dense_replace`` 1); the other 60 a sigmoid router over 384
experts, top 8 on score plus the correction bias (``noaux_tc``, one group),
the chosen scores normalised and scaled by 2.827, SwiGLU experts of 2048
and one shared expert of 2048. Vocabulary 163,840, untied; RMSNorm eps
1e-6. 1.03 T parameters.
"""

from .base import ModelConfig, YarnScaling

CONFIG = ModelConfig(
    name="kimi-k2-instruct",
    family="mla_moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=64,
    head_dim=192,
    d_ff=2048,
    vocab_size=163840,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=50_000.0,
    rope_scaling=YarnScaling(factor=32.0, original_max_position_embeddings=4096, beta_fast=1.0,
                             beta_slow=1.0, mscale=1.0, mscale_all_dim=1.0),
    moe_num_experts=384,
    moe_top_k=8,
    moe_num_shared=1,
    moe_shared_ff=2048,
    moe_first_dense=1,
    moe_dense_ff=18432,
    moe_routed_scale=2.827,
    moe_act="swiglu",
    router_aux_weight=0.0,
    norm_eps=1e-6,
    source="hf: moonshotai/Kimi-K2-Instruct config.json",
)
