"""TinyLlama-1.1B [arXiv:2401.02385; hf] — llama2-arch small, GQA kv=4."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    head_dim=64,
    source="arXiv:2401.02385; hf",
)
