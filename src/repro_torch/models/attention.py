"""GQA attention: dense, chunked, prefill and decode paths (``repro/models/attention.py``).

Layouts as in the reference: activations (B, S, d_model); q (B, S, H, D);
k/v (B, S, KVH, D); weights (in, out). The training paths are plain
PyTorch and follow the reference op for op: QKᵀ in the compute dtype then
cast to f32 and scaled, masks at ``NEG_INF = -1e30`` (not ``-inf``), the
softmax in f32 cast back to ``q.dtype`` before the PV product, and the
GQA expand as ``repeat_interleave`` (``jnp.repeat``).

Serving goes through the two attention kernels. Prefill (``want_cache``)
is a causal forward with no gradient, so it calls ``flash_attention_gqa``;
one-token decode calls ``decode_attention`` against the KV cache, which it
updates in place (the reference donates it). Both pass ``logit_softcap``
to the kernel, which caps the scaled logits where the reference's jnp
does. Decode takes its position as a 0-d int32 tensor on the model's
device and reads nothing back to the host, so a CUDA graph can capture
it (``train/train_step.py``). Training keeps the plain
paths: the flash kernel has no backward and refuses inputs that require
grad. Above ``attn_dense_threshold`` a config with ``attn_shard="seq"``
(phi3, llava) trains through ``_chunked_attention_vecq``, the others
through ``_chunked_attention``.
"""

from __future__ import annotations

import torch

from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention_gqa
from ..parallel.axes import per_shard, shard
from .common import apply_rope, make_rope, scaled_init

__all__ = [
    "attention_block",
    "decode_attention_block",
    "dequantize_kv",
    "init_attention",
    "position",
    "quantize_kv",
    "slot_validity",
]

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


def _chunked_attention_vecq(q, k, v, cfg):
    """Online-softmax over KV chunks with every query block at once.

    The reference's ``attn_shard="seq"`` path: the query blocks are one
    batch axis (which the reference shards over its model axis) and a loop
    over kv blocks carries f32 ``m``, ``l`` and ``acc`` of shape (b, nq, h,
    blk[, d]). Unlike :func:`_chunked_attention` it zeroes ``p`` where the
    mask is off. The outputs agree all the same: the ones that
    ``exp(NEG_INF - NEG_INF)`` adds there for a kv block a row cannot see
    (a window) are wiped by ``corr = 0`` at the row's first valid key.
    """
    blk = min(cfg.attn_chunk, q.shape[1])
    b, s, h, d = q.shape
    if s % blk:
        raise ValueError(f"seq {s} is not a multiple of attn_chunk {blk}")
    nq = s // blk
    scale = d**-0.5
    qb = shard(q.reshape(b, nq, blk, h, d), "batch", "seq_tp", None, None, None)
    kb = k.reshape(b, nq, blk, h, d)
    vb = v.reshape(b, nq, blk, h, d)
    qpos = (torch.arange(nq, device=q.device)[:, None, None] * blk
            + torch.arange(blk, device=q.device)[None, :, None])  # (nq, blk, 1)
    m = torch.full((b, nq, h, blk), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, nq, h, blk), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, nq, h, blk, d), dtype=torch.float32, device=q.device)
    m, l, acc = (shard(t, "batch", "seq_tp", *([None] * (t.ndim - 2))) for t in (m, l, acc))
    for ki in range(nq):
        kk = kb[:, ki]  # (b, blk, h, d)
        vv = vb[:, ki]
        logits = torch.einsum("bnqhd,bkhd->bnhqk", qb, kk).float() * scale
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        kpos = (ki * blk + torch.arange(blk, device=q.device))[None, None, :]
        mask = _mask(qpos, kpos, cfg)[None, :, None]  # (1, nq, 1, blk, blk)
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bnhqk,bkhd->bnhqd", p.to(vv.dtype), vv
        ).float()
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 1, 3, 2, 4).reshape(b, s, h, d).to(q.dtype)


def _qkv_axes(cfg):
    if cfg.attn_shard == "seq":
        # heads not divisible by tp: shard sequence instead
        return ("batch", "seq_tp", "heads_r", None)
    return ("batch", None, "heads", None)


def _per_shard(fn, q, k, v, cfg):
    """``fn(q, k, v, cfg)`` on each device's own (batch, head) block when
    q, k and v are DTensors split over those dims only (the dry run):
    attention is independent per (batch, head). Otherwise (plain tensors,
    or a sequence split) ``fn`` runs as it is."""
    same = {0: 0, 2: 2}
    return per_shard(lambda q_, k_, v_: fn(q_, k_, v_, cfg), q, (0, 2),
                     [(q, same), (k, same), (v, same)], [same])


def attention_block(p, x, cfg, *, positions=None, want_cache=False):
    """Full-sequence attention (train / prefill). Returns (out, (k, v)).

    With ``want_cache`` (prefill, no gradient) the attention runs in the
    flash-attention kernel; otherwise in the plain dense or chunked path.
    """
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    sin, cos = make_rope(positions, cfg.head_dim_, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    kv = (k, v)
    if want_cache:
        out = flash_attention_gqa(q, k, v, causal=cfg.causal, window=cfg.window,
                                  softcap=cfg.logit_softcap)
        out = out.reshape(b, s, cfg.num_heads * cfg.head_dim_) @ p["wo"]
        return out, kv
    k = _expand_kv(k, cfg)
    v = _expand_kv(v, cfg)
    axes = _qkv_axes(cfg)
    q, k, v = shard(q, *axes), shard(k, *axes), shard(v, *axes)
    if s <= cfg.attn_dense_threshold:
        out = _per_shard(_dense_attention, q, k, v, cfg)
    elif cfg.attn_shard == "seq":
        out = _per_shard(_chunked_attention_vecq, q, k, v, cfg)
    else:
        out = _per_shard(_chunked_attention, q, k, v, cfg)
    out = shard(out, *axes)
    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim_) @ p["wo"]
    return out, kv


def quantize_kv(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 quantisation. t: (..., D).

    Scale ``max |t| / 127`` floored at 1e-8, round half to even, clipped to
    ±127; the scale is stored as bf16.
    """
    t32 = t.float()
    scale = torch.clamp(t32.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(t32 / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)


def position(cache_pos, device) -> torch.Tensor:
    """``cache_pos`` as a 0-d int32 tensor on ``device``: a tensor is
    moved (a no-op when it lies there), a Python int is filled in on the
    device (a fill, not a copy from pageable host memory, which would wait
    for the card)."""
    if isinstance(cache_pos, torch.Tensor):
        if cache_pos.ndim:
            raise ValueError(f"cache_pos must be 0-d, got shape {tuple(cache_pos.shape)}")
        return cache_pos.to(device=device, dtype=torch.int32)
    return torch.full((), cache_pos, dtype=torch.int32, device=device)


def slot_validity(cache_pos, s_c: int, window: int, device) -> torch.Tensor:
    """(S_c,) bool: slot ``j`` holds absolute position ``cache_pos -
    ((cache_pos - j) mod S_c)``; valid when that is >= 0 and, with a
    window, inside it. ``cache_pos`` is a 0-d int tensor on ``device`` or
    a Python int; ``torch.remainder`` takes the divisor's sign, as
    ``jnp.mod`` does."""
    cache_pos = position(cache_pos, device)
    j = torch.arange(s_c, device=device, dtype=torch.int32)
    slot_pos = cache_pos - torch.remainder(cache_pos - j, s_c)
    valid = slot_pos >= 0
    if window:
        valid &= slot_pos > cache_pos - window
    return valid


def decode_attention_block(p, x, cache_k, cache_v, cache_pos, cfg,
                           k_scale=None, v_scale=None):
    """One-token decode against a (possibly rotating-window) KV cache.

    x: (B, 1, d); cache_k/v: (B, S_c, KVH, D); ``cache_pos`` the absolute
    position of this token, a 0-d int32 tensor on the model's device (a
    Python int is made one). Writes this token's K/V into slot
    ``cache_pos mod S_c`` of the cache **in place**, an indexed write on
    the device as the reference's ``dynamic_update_slice_in_dim``, and
    returns the block output (B, 1, d). Nothing is read back to the host.
    Keys are stored RoPE'd at absolute positions, so a rotating buffer
    (``S_c == window``) needs no re-rotation.

    With ``cfg.kv_cache_dtype == "int8"`` the cache is int8 with bf16
    per-(token, head) scales (k_scale/v_scale: (B, S_c, KVH, 1)), updated
    in place too; the cache is dequantized in plain PyTorch before the
    kernel, as the reference does.
    """
    b = x.shape[0]
    hd = cfg.head_dim_
    s_c = cache_k.shape[1]
    cache_pos = position(cache_pos, x.device)
    q, k, v = _project_qkv(p, x, cfg)
    sin, cos = make_rope(cache_pos.expand(b, 1), hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    slot = torch.remainder(cache_pos, s_c).long().view(1)
    if cfg.kv_cache_dtype == "int8":
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        for cache, new in ((cache_k, kq), (k_scale, ks), (cache_v, vq), (v_scale, vs)):
            cache.index_copy_(1, slot, new)
        k_eff = dequantize_kv(cache_k, k_scale, x.dtype)
        v_eff = dequantize_kv(cache_v, v_scale, x.dtype)
    else:
        cache_k.index_copy_(1, slot, k.to(cache_k.dtype))
        cache_v.index_copy_(1, slot, v.to(cache_v.dtype))
        k_eff, v_eff = cache_k, cache_v
    valid = slot_validity(cache_pos, s_c, cfg.window, x.device)
    mask = valid[None, :].expand(b, s_c).contiguous()
    out = decode_attention(q[:, 0].contiguous(), k_eff, v_eff, mask,
                           softcap=cfg.logit_softcap)  # (B, H, D)
    return out.reshape(b, 1, cfg.num_heads * hd).to(x.dtype) @ p["wo"]
