"""Model FLOPs of one training step, counted from a configuration's shapes.

Counted on all ``B * S`` positions of the step, padding included, since
the step computes them. Each matrix product of ``m x k`` by ``k x n``
costs ``2 m k n`` forward and twice that backward (the input's gradient
and the weight's), except the frame stub's projection, whose input needs
no gradient (``2 m k n`` backward). Attention's score and value products
cost ``2 S S D`` each per head and row, half of it under a causal mask.
The SSD scan is counted in its chunked form (chunk ``Q``): the ``C Bᵀ``
and intra-chunk products, causal within the chunk and so half, and the
products into and out of the carried states. Elementwise work, norms,
softmax and the optimizer are not counted; nor is the recomputation that
activation checkpointing adds.
"""

from __future__ import annotations

__all__ = ["step_flops"]


def _attention_layer(m: dict, tokens: int, rows: int, seq: int) -> int:
    """One attention + feed-forward layer, forward."""
    d, f = m["d_model"], m["d_ff"]
    hh, kv = m["num_heads"] * m["head_dim"], m["num_kv_heads"] * m["head_dim"]
    proj = 2 * tokens * d * (hh + 2 * kv) + 2 * tokens * hh * d
    mlp = 2 * tokens * d * f * 3
    scores = 2 * 2 * rows * m["num_heads"] * seq * seq * m["head_dim"]
    if m["causal"]:
        scores //= 2
    return proj + mlp + scores


def _mamba_layer(m: dict, tokens: int, seq: int) -> int:
    """One Mamba-2 block, forward."""
    d, n = m["d_model"], m["ssm_state"]
    di = m["ssm_expand"] * d
    heads = di // m["ssm_head_dim"]
    q = min(m["ssm_chunk"], seq)
    proj = 2 * tokens * d * (2 * di + 2 * n + heads) + 2 * tokens * di * d
    conv = 2 * tokens * (di + 2 * n) * m["ssm_conv"]
    intra = (2 * tokens * q * n + 2 * tokens * q * di) // 2   # C Bᵀ, then its weights on x
    states = 2 * 2 * tokens * n * di                          # into and out of the states
    return proj + conv + intra + states


def step_flops(m: dict, batch: int, seq: int) -> int:
    """Forward and backward FLOPs of one step at ``batch`` rows of ``seq``."""
    t = batch * seq
    d, v = m["d_model"], m["vocab_size"]
    fwd = 2 * t * d * v                       # the output head
    stub = 0
    if m.get("frontend") == "frame":
        stub = 2 * t * m["frontend_dim"] * d
    if m["family"] == "encoder":
        fwd += m["num_layers"] * _attention_layer(m, t, batch, seq)
    elif m["family"] == "hybrid":
        sites = m["num_layers"] // m["attn_every"]
        fwd += m["num_layers"] * _mamba_layer(m, t, seq)
        fwd += sites * _attention_layer(m, t, batch, seq)
    else:
        raise ValueError(f"no FLOP count for family {m['family']!r}")
    return 3 * fwd + 2 * stub
