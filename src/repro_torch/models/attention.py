"""GQA attention, dense and chunked paths (``repro/models/attention.py``).

Layouts as in the reference: activations (B, S, d_model); q (B, S, H, D);
k/v (B, S, KVH, D); weights (in, out). The numerics follow the reference
op for op: QKᵀ in the compute dtype then cast to f32 and scaled, masks at
``NEG_INF = -1e30`` (not ``-inf``), the softmax in f32 cast back to
``q.dtype`` before the PV product, and the GQA expand as
``repeat_interleave`` (``jnp.repeat``). Plain PyTorch: the reference
model calls no Pallas kernel here either. The sequence-sharded
``_chunked_attention_vecq`` and the decode path come with later slices.
"""

from __future__ import annotations

import torch

from .common import apply_rope, make_rope, scaled_init

__all__ = ["attention_block", "init_attention"]

NEG_INF = -1e30


def init_attention(gen, cfg, dtype) -> dict:
    d, hd = cfg.d_model, cfg.head_dim_
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": scaled_init(gen, (d, h * hd), dtype),
        "wk": scaled_init(gen, (d, kvh * hd), dtype),
        "wv": scaled_init(gen, (d, kvh * hd), dtype),
        "wo": scaled_init(gen, (h * hd, d), dtype, fan_in=h * hd),
    }


def _project_qkv(p, x, cfg):
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
    return q, k, v


def _expand_kv(k, cfg):
    """(B,S,KVH,D) -> (B,S,H,D) by repeating each kv head over its group."""
    groups = cfg.num_heads // cfg.num_kv_heads
    return torch.repeat_interleave(k, groups, dim=2)


def _mask(qpos, kpos, cfg):
    mask = torch.ones(torch.broadcast_shapes(qpos.shape, kpos.shape),
                      dtype=torch.bool, device=qpos.device)
    if cfg.causal:
        mask &= kpos <= qpos
    if cfg.window:
        mask &= kpos > qpos - cfg.window
    return mask


def _dense_attention(q, k, v, cfg, q_offset=0):
    """Direct (S_q x S_kv) attention with causal/window masking. fp32 softmax."""
    scale = cfg.head_dim_ ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    sq, sk = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = _mask(qpos, kpos, cfg)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _chunked_attention(q, k, v, cfg):
    """Online-softmax over KV chunks, queries blocked — O(S·chunk) memory.

    The flash-attention recurrence in plain PyTorch, as the reference's
    ``lax.scan`` pair: every (q block, kv block) pair is computed and
    masked, none skipped.
    """
    blk = min(cfg.attn_chunk, q.shape[1])
    b, s, h, d = q.shape
    if s % blk:
        raise ValueError(f"seq {s} is not a multiple of attn_chunk {blk}")
    nq = s // blk
    scale = d**-0.5
    qb = q.reshape(b, nq, blk, h, d)
    kb = k.reshape(b, nq, blk, h, d)
    vb = v.reshape(b, nq, blk, h, d)
    ar = torch.arange(blk, device=q.device)
    blocks = []
    for qi in range(nq):
        qi_q = qb[:, qi]  # (b, blk, h, d)
        m = torch.full((b, h, blk), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, blk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, blk, d), dtype=torch.float32, device=q.device)
        for ki in range(nq):
            kk = kb[:, ki]
            vv = vb[:, ki]
            logits = torch.einsum("bqhd,bkhd->bhqk", qi_q, kk).float() * scale
            if cfg.logit_softcap:
                logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
            mask = _mask(qi * blk + ar[:, None], ki * blk + ar[None, :], cfg)
            logits = torch.where(mask[None, None], logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vv.dtype), vv
            ).float()
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        blocks.append(out.transpose(1, 2).to(q.dtype))  # (b, blk, h, d)
    return torch.stack(blocks, dim=1).reshape(b, s, h, d)


def attention_block(p, x, cfg, *, positions=None):
    """Full-sequence attention (train / prefill). Returns (out, (k, v))."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    sin, cos = make_rope(positions, cfg.head_dim_, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    kv = (k, v)
    k = _expand_kv(k, cfg)
    v = _expand_kv(v, cfg)
    if s <= cfg.attn_dense_threshold:
        out = _dense_attention(q, k, v, cfg)
    elif cfg.attn_shard == "seq":
        raise NotImplementedError(
            "attn_shard='seq' (_chunked_attention_vecq) is not ported yet: "
            "ROADMAP.md §1 item 6 (dense-family remainder)"
        )
    else:
        out = _chunked_attention(q, k, v, cfg)
    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim_) @ p["wo"]
    return out, kv
