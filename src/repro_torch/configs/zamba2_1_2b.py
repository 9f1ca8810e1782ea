"""Zamba2-1.2B [arXiv:2411.15242; hf] — Mamba2 backbone + shared attention.

38 Mamba2 blocks; one *shared* attention+MLP block (single parameter set)
applied after every 6th Mamba2 block (Zamba's parameter-sharing design).
``window=4096`` bounds the shared block's KV at 500k-context decode (the
sub-quadratic requirement of the long_500k cell; DESIGN.md §7 note — the
released model uses full attention at 4k context, where window=4096 is
equivalent).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    window=4096,
    source="arXiv:2411.15242; hf",
)
