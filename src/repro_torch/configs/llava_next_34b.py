"""LLaVA-NeXT-34B [hf:llava-hf; unverified] — VLM backbone, anyres tiling.

Assignment: the modality frontend is a STUB — ``input_specs`` supplies
precomputed patch embeddings (anyres 4-tile + base ≈ 2304 patches of dim
1024) that a linear connector projects into the 7168-wide decoder. 56 heads
do not divide the 16-way tensor axis -> sequence-sharded attention.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    attn_shard="seq",
    frontend="patch",
    frontend_dim=1024,
    frontend_len=2304,
    source="hf:llava-hf/llava-v1.6; unverified",
)
