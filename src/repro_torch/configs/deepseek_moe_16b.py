"""DeepSeekMoE-16B [arXiv:2401.06066; hf] — 2 shared + 64 routed, top-6,
fine-grained experts (d_ff=1408); first layer dense (d_ff=10944)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    head_dim=128,
    moe_num_experts=64,
    moe_top_k=6,
    moe_num_shared=2,
    moe_first_dense=1,
    moe_dense_ff=10944,
    source="arXiv:2401.06066; hf",
)
