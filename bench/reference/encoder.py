"""Plain reference of the encoder family (hubert-xlarge), float32.

A stack of pre-norm residual blocks, each softmax attention over every
position (no causal mask, no key mask: padded frames are attended, as the
program under test attends them) and a SwiGLU feed-forward. The input is
the frame stub: each position's frame is the one-hot vector of ``token %
frontend_dim``, projected by the ``frontend`` matrix, which is that
matrix's row. The head predicts ``vocab_size`` targets. Leaves are named
and stacked over layers as in the program's checkpoints, so that both
sides can be given the same weights.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .common import Precision, apply_rope, attention, lm_loss_sums, rms_norm, rope_tables, swiglu

__all__ = ["loss_sums", "param_specs"]


def param_specs(m: dict) -> dict:
    """{leaf path: (shape, init)}; init is ("normal", std), ("scaled",
    fan_in) for a normal of std 1/sqrt(fan_in), or ("zeros",)."""
    d, v, f = m["d_model"], m["vocab_size"], m["d_ff"]
    hh = m["num_heads"] * m["head_dim"]
    kv = m["num_kv_heads"] * m["head_dim"]
    n = m["num_layers"]
    seg = "segments/0/"
    return {
        "embed": ((v, d), ("normal", 0.02)),
        "final_norm": ((d,), ("zeros",)),
        "lm_head": ((d, v), ("scaled", d)),
        "frontend": ((m["frontend_dim"], d), ("scaled", m["frontend_dim"])),
        seg + "ln1": ((n, d), ("zeros",)),
        seg + "ln2": ((n, d), ("zeros",)),
        seg + "attn/wq": ((n, d, hh), ("scaled", d)),
        seg + "attn/wk": ((n, d, kv), ("scaled", d)),
        seg + "attn/wv": ((n, d, kv), ("scaled", d)),
        seg + "attn/wo": ((n, hh, d), ("scaled", hh)),
        seg + "mlp/wi_gate": ((n, d, f), ("scaled", d)),
        seg + "mlp/wi_up": ((n, d, f), ("scaled", d)),
        seg + "mlp/wo": ((n, f, d), ("scaled", f)),
    }


def attn_block(p: dict, x, m: dict, sin, cos, prec: Precision, *, causal: bool, window: int):
    """x + attention(rms_norm(x)) for one layer's leaves ``p``."""
    b, s, _ = x.shape
    hd, h, kvh = m["head_dim"], m["num_heads"], m["num_kv_heads"]
    hn = rms_norm(x, p["ln1"], m["norm_eps"])
    q = prec.mm(hn, p["wq"]).reshape(b, s, h, hd)
    k = prec.mm(hn, p["wk"]).reshape(b, s, kvh, hd)
    v = prec.mm(hn, p["wv"]).reshape(b, s, kvh, hd)
    q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
    k = torch.repeat_interleave(k, h // kvh, dim=2)
    v = torch.repeat_interleave(v, h // kvh, dim=2)
    o = attention(q, k, v, causal=causal, window=window, prec=prec)
    return x + prec.mm(o.reshape(b, s, h * hd), p["wo"])


def mlp_block(p: dict, x, m: dict, prec: Precision):
    """x + SwiGLU(rms_norm(x))."""
    hn = rms_norm(x, p["ln2"], m["norm_eps"])
    return x + swiglu(hn, p["wi_gate"], p["wi_up"], p["mlp_wo"], prec)


def layer_leaves(params: dict, prefix: str, i: "int | None") -> dict:
    """One attention + feed-forward layer's leaves under ``prefix``, taken
    at layer ``i`` of the stacks (or unstacked for ``None``)."""
    pick = (lambda t: t) if i is None else (lambda t: t[i])
    names = {"ln1": "ln1", "ln2": "ln2", "wq": "attn/wq", "wk": "attn/wk", "wv": "attn/wv",
             "wo": "attn/wo", "wi_gate": "mlp/wi_gate", "wi_up": "mlp/wi_up",
             "mlp_wo": "mlp/wo"}
    return {k: pick(params[prefix + v]) for k, v in names.items()}


def layer(p: dict, x, m: dict, sin, cos, prec: Precision):
    """One whole attention + feed-forward layer (a unit the backward pass
    recomputes, so that only the layers' inputs are kept)."""
    x = attn_block(p, x, m, sin, cos, prec, causal=m["causal"], window=m["window"])
    return mlp_block(p, x, m, prec)


def logits_of(params: dict, x, m: dict, prec: Precision):
    return prec.mm(rms_norm(x, params["final_norm"], m["norm_eps"]), params["lm_head"])


def loss_sums(params: dict, tokens, targets, mask, m: dict, prec: Precision) -> tuple:
    """(masked cross-entropy sum, masked logsumexp² sum) over these rows."""
    x = prec.q(params["frontend"])[tokens.long() % m["frontend_dim"]]
    sin, cos = rope_tables(x.shape[1], m["head_dim"], m["rope_theta"], x.device)
    for i in range(m["num_layers"]):
        x = checkpoint(layer, layer_leaves(params, "segments/0/", i), x, m, sin, cos, prec,
                       use_reentrant=False)
    return lm_loss_sums(logits_of(params, x, m, prec), targets, mask)
