"""Optimizers: AdamW with an f32 master copy (``repro/optim/optimizers.py``).

A tree here is the flat ``{path: tensor}`` dict of
:func:`repro_torch.models.common.flatten_tree`, in the reference's leaf
order. The arithmetic is the reference's, step for step: the learning
rate warms up over 200 steps then follows a cosine to 10 000 with a 0.1
floor, AdamW has b1 0.9, b2 0.95, eps 1e-8, decoupled weight decay on
every tensor of rank >= 2 (the stacked ``(L, d)`` norm scales included,
``final_norm`` not), and the new parameter is the f32 master cast to the
parameter dtype.

Unlike the reference, which returns new trees, ``update`` works in place:
the moments, the master copy and the parameters are overwritten, so a
step holds one set of optimizer state on the card, not two.

Adafactor and SGD-momentum are not ported yet (ROADMAP.md §1 item 7).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..configs.base import RunConfig

__all__ = ["Optimizer", "clip_by_global_norm", "global_norm", "make_optimizer"]


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves, in leaf order, of sum(g²) in f32."""
    total = 0
    for g in tree.values():
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(tree: dict, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in tree.items()}, norm


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: callable     # values -> opt_state
    update: callable   # (grads, opt_state, values, step) -> None (in place)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _lr(step, cfg: RunConfig, warmup=200, total=10_000) -> torch.Tensor:
    step = _f32(step)
    warm = cfg.learning_rate * (step + 1) / warmup
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = cfg.learning_rate * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm,
                       torch.clamp(cos, min=cfg.learning_rate * 0.1))


def make_optimizer(cfg: RunConfig) -> Optimizer:
    if cfg.optimizer == "adamw":
        return _adamw(cfg)
    if cfg.optimizer in ("adafactor", "sgdm"):
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported yet: ROADMAP.md §1 item 7"
        )
    raise ValueError(cfg.optimizer)


# ------------------------------------------------------------------- AdamW
def _adamw(cfg: RunConfig, b1=0.9, b2=0.95, eps=1e-8):
    @torch.no_grad()
    def init(values: dict) -> dict:
        st = {
            "m": {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                  for k, v in values.items()},
            "v": {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                  for k, v in values.items()},
        }
        if cfg.master_fp32:
            # A copy even for f32 params: the master must not alias them.
            st["master"] = {k: v.detach().to(torch.float32, copy=True)
                            for k, v in values.items()}
        return st

    @torch.no_grad()
    def update(grads: dict, state: dict, values: dict, step) -> None:
        # lr, c1 and c2 are 0-d CPU tensors, which CUDA ops take as scalars.
        lr = _lr(step, cfg)
        t = _f32(step) + 1
        c1 = 1 - b1**t
        c2 = 1 - b2**t
        for k, g in grads.items():
            p = values[k]
            m, v = state["m"][k], state["v"][k]
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            master = state["master"][k] if cfg.master_fp32 else p.float()
            if p.ndim >= 2:  # decoupled weight decay on matrices only
                u = u + cfg.weight_decay * master
            new = master - lr * u
            if cfg.master_fp32:
                master.copy_(new)
            p.copy_(new.to(p.dtype))

    return Optimizer(init, update)
