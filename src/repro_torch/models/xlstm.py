"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory) and sLSTM
(scalar) (``repro/models/xlstm.py``), op for op the reference's.

mLSTM runs in its chunkwise-parallel form: per head a matrix memory
C (dh x dh) and a normaliser n (dh) decay with a scalar sigmoid forget
gate and accumulate i_t k_t v_tᵀ; the reference's ``lax.scan`` over chunks
is a Python loop here, and a prompt must be at most 256 tokens or a
multiple of 256 (``mlstm_block`` raises a ``ValueError`` otherwise, the
reference's rule). sLSTM keeps the paper's exponential gating with the
m_t stabiliser; it is sequential, so its scan is a loop of one
``_slstm_cell`` a time step, starting from ``m = -1e30``. The recurrent
matrices ``r_*`` are block-diagonal per head and ``init_slstm`` zeroes
them, as the reference does. The four gates' products run stacked (one
batched product for the four ``W x`` and one for the four ``R h``); each
gate's arithmetic is the reference's.

The states are f32. Decode updates the cache's state tensors in place,
where the reference returns new arrays.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.axes import shard
from .common import rms_norm, scaled_init

__all__ = [
    "init_mlstm",
    "init_slstm",
    "mlstm_block",
    "mlstm_decode",
    "mlstm_state_shape",
    "slstm_block",
    "slstm_decode",
    "slstm_state_shape",
]

_GATES = ("z", "i", "f", "o")


# --------------------------------------------------------------------- mLSTM
def _mlstm_dims(cfg):
    di = int(cfg.mlstm_proj_factor * cfg.d_model)
    heads = cfg.num_heads
    dh = di // heads
    return di, heads, dh


def init_mlstm(gen, cfg, dtype) -> dict:
    """Draws in the reference's order: w_up, wq, wk, wv, w_i, w_f, w_down."""
    d = cfg.d_model
    di, heads, dh = _mlstm_dims(cfg)
    device = gen.device
    p = {
        "w_up": scaled_init(gen, (d, 2 * di), dtype),
        "wq": scaled_init(gen, (di, di), dtype),
        "wk": scaled_init(gen, (di, di), dtype),
        "wv": scaled_init(gen, (di, di), dtype),
        "w_i": scaled_init(gen, (di, heads), dtype),
        "w_f": scaled_init(gen, (di, heads), dtype),
        "b_f": torch.full((heads,), 3.0, dtype=dtype, device=device),  # open forget gates
        "out_norm": torch.zeros((di,), dtype=dtype, device=device),
    }
    p["w_down"] = scaled_init(gen, (di, d), dtype, fan_in=di)
    return p


def mlstm_state_shape(cfg, batch) -> dict:
    di, heads, dh = _mlstm_dims(cfg)
    return {"C": (batch, heads, dh, dh), "n": (batch, heads, dh)}


def _mlstm_chunked(q, k, v, ig, lf, chunk, init_state=None):
    """Chunkwise mLSTM. q/k/v: (b,s,h,dh) f32; ig (sigmoid'd): (b,s,h);
    lf = log f (negative): (b,s,h). Returns (y, {"C", "n"})."""
    b, s, h, dh = q.shape
    nc = s // chunk
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    qc = q.reshape(b, nc, chunk, h, dh).transpose(0, 1)
    kc = k.reshape(b, nc, chunk, h, dh).transpose(0, 1)
    vc = v.reshape(b, nc, chunk, h, dh).transpose(0, 1)
    ic = ig.reshape(b, nc, chunk, h).transpose(0, 1)
    fc = lf.reshape(b, nc, chunk, h).transpose(0, 1)

    if init_state is None:
        C = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=q.device)
        n = torch.zeros((b, h, dh), dtype=torch.float32, device=q.device)
    else:
        C, n = init_state["C"].float(), init_state["n"].float()
    ys = []
    for qq, kk, vv, ii, ff in zip(qc, kc, vc, ic, fc):
        seg = torch.cumsum(ff, dim=1)          # (b, chunk, h)
        total = seg[:, -1]
        li = seg[:, :, None, :]
        lj = seg[:, None, :, :]
        decay = torch.exp(torch.where(mask[None, :, :, None], li - lj, -torch.inf))
        qk = torch.einsum("bqhd,bkhd->bqkh", qq, kk)
        w = qk * decay * ii[:, None, :, :]     # (b,q,k,h)
        y = torch.einsum("bqkh,bkhd->bqhd", w, vv)
        den = w.sum(dim=2)                     # q·n_q, intra part (b,q,h)
        # inter-chunk
        pd = torch.exp(seg)                    # decay applied to entering state
        y = y + torch.einsum("bqh,bqhd,bhde->bqhe", pd, qq, C)
        den = den + torch.einsum("bqh,bqhd,bhd->bqh", pd, qq, n)
        # state update
        wdec = torch.exp(total[:, None, :] - seg) * ii  # (b,k,h)
        C = C * torch.exp(total)[:, :, None, None] + torch.einsum(
            "bkh,bkhd,bkhe->bhde", wdec, kk, vv)
        n = n * torch.exp(total)[:, :, None] + torch.einsum("bkh,bkhd->bhd", wdec, kk)
        ys.append(y / torch.clamp(torch.abs(den), min=1.0)[..., None])
    y = torch.stack(ys, dim=1).reshape(b, s, h, dh)
    return y, {"C": C, "n": n}


def _mlstm_qkvif(p, x, cfg):
    b, s, _ = x.shape
    di, heads, dh = _mlstm_dims(cfg)
    u = x @ p["w_up"]
    xin, z = u[..., :di], u[..., di:]
    q = (xin @ p["wq"]).reshape(b, s, heads, dh)
    k = (xin @ p["wk"]).reshape(b, s, heads, dh) * dh**-0.5
    v = (xin @ p["wv"]).reshape(b, s, heads, dh)
    ig = torch.sigmoid((xin @ p["w_i"]).float())
    lf = F.logsigmoid((xin @ p["w_f"]).float() + p["b_f"].float())
    return q, k, v, ig, lf, z


def mlstm_block(p, x, cfg, *, init_state=None, chunk=256):
    """x: (B,S,d) -> (out, {"C", "n"} final f32 state)."""
    b, s, d = x.shape
    di, heads, dh = _mlstm_dims(cfg)
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the mLSTM chunk {chunk}")
    q, k, v, ig, lf, z = _mlstm_qkvif(p, x, cfg)
    q = shard(q, "batch", None, None, "inner_heads")
    y, state = _mlstm_chunked(q.float(), k.float(), v.float(), ig, lf, chunk, init_state)
    y = y.reshape(b, s, di).to(x.dtype)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps) * F.silu(z)
    return y @ p["w_down"], state


def mlstm_decode(p, x, state, cfg):
    """One token. x: (B,1,d). Updates ``state["C"]`` and ``state["n"]`` in
    place; returns ``(out, state)``."""
    b = x.shape[0]
    di, heads, dh = _mlstm_dims(cfg)
    q, k, v, ig, lf, z = _mlstm_qkvif(p, x, cfg)
    q0, k0, v0 = (t[:, 0].float() for t in (q, k, v))
    f = torch.exp(lf[:, 0])  # (b,h)
    i = ig[:, 0]
    C = state["C"] * f[:, :, None, None] + i[:, :, None, None] * torch.einsum(
        "bhd,bhe->bhde", k0, v0)
    n = state["n"] * f[:, :, None] + i[:, :, None] * k0
    y = torch.einsum("bhd,bhde->bhe", q0, C)
    den = torch.abs(torch.einsum("bhd,bhd->bh", q0, n))
    y = (y / torch.clamp(den, min=1.0)[..., None]).reshape(b, 1, di).to(x.dtype)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps) * F.silu(z)
    state["C"].copy_(C)
    state["n"].copy_(n)
    return y @ p["w_down"], state


# --------------------------------------------------------------------- sLSTM
def _slstm_dims(cfg):
    d = cfg.d_model
    heads = cfg.num_heads
    dh = d // heads
    return d, heads, dh


def init_slstm(gen, cfg, dtype) -> dict:
    """Draws in the reference's order: w_g then r_g for g in z, i, f, o,
    then w_out. ``r_*`` are drawn and multiplied by 0.0, as the reference's."""
    d, heads, dh = _slstm_dims(cfg)
    device = gen.device
    p = {}
    for g in _GATES:
        p[f"w_{g}"] = scaled_init(gen, (d, d), dtype)
        p[f"r_{g}"] = scaled_init(gen, (heads, dh, dh), dtype, fan_in=dh) * 0.0
        p[f"b_{g}"] = torch.full((d,), 1.0 if g == "f" else 0.0, dtype=dtype, device=device)
    p["out_norm"] = torch.zeros((d,), dtype=dtype, device=device)
    p["w_out"] = scaled_init(gen, (d, d), dtype)
    return p


def slstm_state_shape(cfg, batch) -> dict:
    d, heads, dh = _slstm_dims(cfg)
    return {"c": (batch, d), "n": (batch, d), "h": (batch, d), "m": (batch, d)}


def _slstm_cell(xg, state, r, bias, cfg):
    """One time step. xg (4, b, d): the pre-computed W x_t of the gates z,
    i, f, o; r (4, heads, dh, dh) and bias (4, d) in f32; state (c, n, h, m)."""
    d, heads, dh = _slstm_dims(cfg)
    c, n, h, m = state
    rec = torch.einsum("bhd,ghde->gbhe", h.reshape(-1, heads, dh), r)
    pre = xg + rec.reshape(4, -1, d) + bias[:, None, :]
    zt = torch.tanh(pre[0])
    it = pre[1]
    ft = pre[2]
    ot = torch.sigmoid(pre[3])
    # exponential gating with stabiliser (xLSTM eq. 15-17)
    m_new = torch.maximum(ft + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(ft + m - m_new)
    c_new = f_p * c + i_p * zt
    n_new = f_p * n + i_p
    h_new = ot * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, h_new, m_new


def _slstm_weights(p):
    """The gates' W (4, d, d), R (4, heads, dh, dh) and b (4, d), in f32."""
    return tuple(torch.stack([p[f"{w}_{g}"].float() for g in _GATES]) for w in "wrb")


def slstm_block(p, x, cfg, *, init_state=None):
    """x: (B,S,d) -> (out, {"c", "n", "h", "m"} final f32 state)."""
    b, s, d = x.shape
    w, r, bias = _slstm_weights(p)
    pre = torch.einsum("bsd,gde->gbse", x.float(), w)
    if init_state is None:
        z0 = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        state = (z0, z0, z0, z0 - 1e30)
    else:
        state = tuple(init_state[k].float() for k in ("c", "n", "h", "m"))
    hs = []
    for t in range(s):
        state = _slstm_cell(pre[:, :, t], state, r, bias, cfg)
        hs.append(state[2])
    y = torch.stack(hs, dim=1).to(x.dtype)  # (b, s, d)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    c, n, h, m = state
    return y @ p["w_out"], {"c": c, "n": n, "h": h, "m": m}


def slstm_decode(p, x, state, cfg):
    """One token. x: (B,1,d). Updates the four state tensors in place;
    returns ``(out, state)``."""
    w, r, bias = _slstm_weights(p)
    xg = torch.einsum("bd,gde->gbe", x[:, 0].float(), w)
    new = _slstm_cell(xg, tuple(state[k].float() for k in ("c", "n", "h", "m")), r, bias, cfg)
    for k, t in zip(("c", "n", "h", "m"), new):
        state[k].copy_(t)
    y = rms_norm(new[2][:, None].to(x.dtype), p["out_norm"], cfg.norm_eps)
    return y @ p["w_out"], state
