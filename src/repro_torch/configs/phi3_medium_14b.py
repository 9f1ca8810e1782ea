"""Phi-3-medium-14B [arXiv:2404.14219] — dense, RoPE, SwiGLU, GQA kv=10.

40 heads do not divide the 16-way tensor axis -> sequence-sharded attention
fallback (``attn_shard="seq"``; see models/attention.py).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    head_dim=128,
    attn_shard="seq",
    source="arXiv:2404.14219; unverified",
)
