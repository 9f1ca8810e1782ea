"""The train step (``repro/train/train_step.py``).

    loss(values) -> grads -> [cast to grad_allreduce_dtype] -> clip -> optimizer

``build_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``. The state is ``{"values", "opt", "step"}`` with the
reference's structure (``values`` the model's parameter tree, so a
checkpoint's keys are the reference's). The step updates parameters and
optimizer state in place and returns the same state dict; ``metrics``
holds device tensors (``loss``, ``grad_norm``, ``ce``, ``z_loss``,
``aux``) that are not synchronised. Microbatching splits the batch along
its first axis and accumulates gradients in the parameter dtype, or in
``grad_allreduce_dtype`` when one is set, as the reference's scan does.

``build_prefill_step`` / ``build_decode_step`` are the serving programs:
prefill runs the prompt through the model (attention in the flash kernel,
the Mamba-2 scan in the ssd_scan kernel) and sizes its K/V into the decode
cache; decode runs one token (attention in the decode kernel) and updates
that cache, K/V and recurrent states alike, in place, where the reference
donates it. Both run under ``torch.inference_mode()``.
"""

from __future__ import annotations

import torch

from ..configs.base import RunConfig
from ..models.common import flatten_tree
from ..models.attention import quantize_kv
from ..models.transformer import ATTN_KINDS, Model
from ..optim.optimizers import Optimizer, clip_by_global_norm
from .losses import lm_loss

__all__ = ["build_decode_step", "build_prefill_step", "build_train_step", "init_train_state"]

def init_train_state(model: Model, optimizer: Optimizer, seed: int = 0) -> dict:
    """Initialise ``model``'s parameters from ``seed`` and the optimizer
    state over them."""
    model.init(seed)
    return fresh_train_state(model, optimizer)


def fresh_train_state(model: Model, optimizer: Optimizer) -> dict:
    """Train state over ``model``'s current parameters (e.g. loaded weights)."""
    values = model.values()
    return {
        "values": values,
        "opt": optimizer.init(flatten_tree(values)),
        "step": torch.zeros((), dtype=torch.int32),
    }


def build_train_step(model: Model, run_cfg: RunConfig, optimizer: Optimizer):
    cfg = model.cfg

    def loss_fn(batch):
        logits, aux = model(batch, remat=run_cfg.remat)
        return lm_loss(
            logits,
            batch["targets"],
            batch["loss_mask"],
            aux=aux,
            aux_weight=cfg.router_aux_weight if cfg.moe_num_experts else 0.0,
        )

    def grad_fn(params: dict, batch):
        loss, metrics = loss_fn(batch)
        # A leaf the loss never reads (a frame arch's token embedding) gets
        # a zero gradient, as jax.grad gives it.
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                    materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, dict(zip(params, grads))

    def compute_grads(params: dict, batch):
        k = run_cfg.microbatch
        if not (k and k > 1):
            return grad_fn(params, batch)
        micro = [
            {key: x.reshape(k, x.shape[0] // k, *x.shape[1:])[i] for key, x in batch.items()}
            for i in range(k)
        ]
        # Accumulate in the param dtype (bf16 for big models) unless a
        # grad dtype is forced, as the reference does.
        acc_dt = (getattr(torch, run_cfg.grad_allreduce_dtype)
                  if run_cfg.grad_allreduce_dtype else None)
        loss = torch.zeros((), dtype=torch.float32)
        grads = {p: torch.zeros_like(v, dtype=acc_dt or v.dtype) for p, v in params.items()}
        for mb in micro:
            l, metrics, g = grad_fn(params, mb)
            loss = loss + l
            for p, gp in g.items():
                grads[p] = grads[p] + gp.to(grads[p].dtype)
        return loss / k, metrics, {p: g / k for p, g in grads.items()}

    def train_step(state: dict, batch: dict):
        params = flatten_tree(state["values"])
        loss, metrics, grads = compute_grads(params, batch)
        if run_cfg.grad_allreduce_dtype:
            dt = getattr(torch, run_cfg.grad_allreduce_dtype)
            grads = {p: g.to(dt) for p, g in grads.items()}
        grads, gnorm = clip_by_global_norm(grads, run_cfg.grad_clip)
        optimizer.update(grads, state["opt"], params, state["step"])
        state["step"] = state["step"] + 1
        return state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


# ------------------------------------------------------------------ serving
def _size_cache(t, s_c: int) -> torch.Tensor:
    """(n, B, S, KVH, D) prompt K or V -> (n, B, S_c, KVH, D) decode slots:
    positions 0..S-1 in slots 0..S-1 when they fit, else the last S_c
    positions in the rotating-window layout ``slot = position % S_c``."""
    s = t.shape[2]
    out = t.new_zeros(t.shape[:2] + (s_c,) + t.shape[3:])
    if s_c >= s:
        out[:, :, :s] = t
    else:
        pos = torch.arange(s - s_c, s, device=t.device)
        out[:, :, torch.remainder(pos, s_c)] = t[:, :, pos]
    return out


def build_prefill_step(model: Model, max_len: int):
    """Full-prompt pass that builds the decode cache (sized to ``max_len``).

    ``prefill(inputs) -> (logits[:, -1:], caches)``; ``inputs`` holds
    ``tokens`` and, for a ``patch`` frontend, ``patch_embeds``, whose
    positions come first. As in the reference, a prefill longer than
    ``max_len`` (patches included) keeps only its last ``max_len``
    positions, in the rotating layout. Attention K/V are sized
    into decode slots (a shared_attn site's gaining its leading axis 1 and
    int8 applying where configured); a recurrent state is already the
    cache and passes through.
    """
    cfg = model.cfg

    @torch.inference_mode()
    def prefill(inputs: dict):
        logits, _, caches = model(inputs, want_cache=True)
        s_c = min(max_len, cfg.window) if cfg.window else max_len
        sized = []
        for (kind, _), cache in zip(cfg.segments(), caches):
            if kind not in ATTN_KINDS:
                sized.append(cache)  # recurrent state is already the cache
                continue
            if kind == "shared_attn":
                cache = {name: t[None] for name, t in cache.items()}
            k_c, v_c = _size_cache(cache["k"], s_c), _size_cache(cache["v"], s_c)
            if cfg.kv_cache_dtype == "int8":
                kq, ks = quantize_kv(k_c)
                vq, vs = quantize_kv(v_c)
                sized.append({"k": kq, "k_scale": ks, "v": vq, "v_scale": vs})
            else:
                sized.append({"k": k_c, "v": v_c})
        return logits[:, -1:], sized

    return prefill


def build_decode_step(model: Model):
    """``decode(caches, tokens (B, 1), cache_pos) -> (logits (B, 1, V),
    caches)``, the caches updated in place."""

    @torch.inference_mode()
    def decode(caches, tokens, cache_pos: int):
        return model.decode_step(caches, tokens, cache_pos)

    return decode
