"""NVIDIA-Nemotron-3-Nano-30B-A3B [hf: nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16,
config.json, model type ``nemotron_h``] — 52 single-mixer pre-norm layers.

``hybrid_override_pattern`` orders them: 23 Mamba-2 layers (M; 64 heads of
64, so d_inner 4096, 8 groups of B and C, state 128, chunk 128, conv 4 with
bias, a gated RMSNorm over groups of 512 channels before ``out_proj``), 23
MoE layers (E; a sigmoid router over 128 experts, top 6 chosen on score
plus a correction bias, the chosen scores normalised and scaled by 2.5;
non-gated relu² experts of width 1856 and one shared expert of 3712) and 6
GQA attention layers (*; 32 query and 2 KV heads of 128, no rotary
positions). 31.58 B parameters, vocabulary 131,072, untied.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-3-nano-30b-a3b",
    family="nemotron_h",
    num_layers=52,
    layer_pattern="MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME",
    d_model=2688,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=1856,
    vocab_size=131072,
    rope=False,
    moe_num_experts=128,
    moe_top_k=6,
    moe_num_shared=1,
    moe_shared_ff=3712,
    moe_routed_scale=2.5,
    router_aux_weight=0.0,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_heads=64,
    ssm_head_dim=64,
    ssm_groups=8,
    ssm_chunk=128,
    ssm_gated_norm=True,
    norm_eps=1e-5,
    source="hf: nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16 config.json",
)
