"""xLSTM-350M [arXiv:2405.04517] — sLSTM + mLSTM blocks (d_ff=0: the
up/down projections live inside the blocks). Every 8th block is sLSTM
(≈7:1 mLSTM:sLSTM, the paper's ratio)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,
    mlstm_proj_factor=2.0,
    source="arXiv:2405.04517; unverified",
)
