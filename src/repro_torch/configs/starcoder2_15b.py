"""StarCoder2-15B [arXiv:2402.19173; hf] — dense, GQA kv=4, RoPE."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    rope_theta=100_000.0,
    source="arXiv:2402.19173; hf",
)
