"""Kimi-K2 1T-A32B [arXiv:2501.kimi2 paper-table] — trillion-param MoE.

384 routed experts top-8 + 1 shared, fine-grained d_ff=2048, first layer
dense (d_ff=18432). head_dim = 7168/64 = 112 per the assignment table (MXU
pads 112->128; noted in the roofline). Requires FSDP + factored optimizer to
fit 16 GB/chip HBM at 512 chips (see RunConfig overrides in launch/dryrun).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    head_dim=112,
    moe_num_experts=384,
    moe_top_k=8,
    moe_num_shared=1,
    moe_first_dense=1,
    moe_dense_ff=18432,
    capacity_factor=1.0,
    source="arXiv:2501.kimi2; unverified (paper-table)",
)
