"""HuBERT-XLarge [arXiv:2106.07447] — encoder-only audio transformer.

Assignment: the conv waveform frontend is a STUB — ``input_specs`` supplies
precomputed frame embeddings (dim 512). Training is masked-unit prediction
over the 504-unit codebook (the HuBERT objective); decode shapes are
skipped (no autoregressive step). vocab 504 does not divide the tensor
axis -> the (tiny) output head is replicated.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    head_dim=80,
    causal=False,
    frontend="frame",
    frontend_dim=512,
    source="arXiv:2106.07447; unverified",
)
