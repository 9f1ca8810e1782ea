"""Optimizers: AdamW, Adafactor and SGD-momentum (``repro/optim/optimizers.py``).

A tree here is the flat ``{path: tensor}`` dict of
:func:`repro_torch.models.common.flatten_tree`, in the reference's leaf
order. The arithmetic is the reference's, step for step: the learning
rate warms up over 200 steps then follows a cosine to 10 000 with a 0.1
floor, AdamW has b1 0.9, b2 0.95, eps 1e-8, decoupled weight decay on
every tensor of rank >= 2 (the stacked ``(L, d)`` norm scales included,
``final_norm`` not), and the new parameter is the f32 master cast to the
parameter dtype.

Adafactor (decay 0.8, eps 1e-30, RMS clip 1.0) keeps, per leaf of rank >=
2, the row means ``vr`` (over the last axis) and column means ``vc`` (over
axis -2) of g² + eps, and a full ``v`` for the others; in the stacked tree
a layer leaf is (L, d_in, d_out), so ``vr`` and ``vc`` keep the layers
axis, and the RMS clip's mean runs over the whole stacked leaf, all its
layers at once, as the reference's does. Its f32 master is optional
(``master_fp32``); without it the parameters are updated directly. SGDM
(momentum 0.9, no weight decay) always keeps an f32 master. The state
trees are the reference's: ``{"v": {leaf: {"vr", "vc"} | {"v"}},
"master"?}`` and ``{"mom", "master"}``, so checkpoints cross both ways.

Unlike the reference, which returns new trees, ``update`` works in place:
the moments, the master copy and the parameters are overwritten, so a
step holds one set of optimizer state on the card, not two.

``update(grads, state, values, step, max_norm=inf) -> norm`` is the train
step's call: it clips the gradients by their global norm (the norm is
returned; the default max norm leaves them as they are), then updates,
leaf by leaf. AdamW with its f32 master on CUDA leaves instead runs both as
two launches of ``kernels/fused_adamw`` (the same numbers, 30 bytes a
parameter moved instead of 214), which raise on a card tree they do not
take; CPU, meta and DTensor leaves, AdamW without a master, Adafactor and
SGDM take the loop, which is the plain version of those kernels.

``state_axes(values_axes)`` maps the parameters' ``{path: logical axes}``
(``Model.param_axes()``) to the logical axes of every state leaf, the
structure ``init`` builds, as the reference's does (Adafactor's ``vr``
drops the last axis, ``vc`` the one before it).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..configs.base import RunConfig
from ..kernels.fused_adamw import ops as fused

__all__ = ["Optimizer", "clip_by_global_norm", "clip_scale", "global_norm", "make_optimizer"]


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves, in leaf order, of sum(g²) in f32."""
    total = 0
    for g in tree.values():
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / max(norm, 1e-9)), the factor the clip applies."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: dict, max_norm: float):
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
    return {k: (g.float() * scale).to(g.dtype) for k, g in tree.items()}, norm


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: callable        # values -> opt_state
    update: callable      # (grads, opt_state, values, step, max_norm=inf) -> norm (in place)
    state_axes: callable  # values_axes -> opt_state's logical axes


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _lr(step, cfg: RunConfig, warmup=200, total=10_000) -> torch.Tensor:
    """The learning rate at ``step``, a 0-d f32 tensor on ``step``'s device
    (the train state keeps the step on the model's, so that a captured
    step computes its rate, and the bias corrections, at every replay)."""
    step = _f32(step)
    warm = cfg.learning_rate * (step + 1) / warmup
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = cfg.learning_rate * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm,
                       torch.clamp(cos, min=cfg.learning_rate * 0.1))


def make_optimizer(cfg: RunConfig) -> Optimizer:
    if cfg.optimizer == "adamw":
        return _adamw(cfg)
    if cfg.optimizer == "adafactor":
        return _adafactor(cfg)
    if cfg.optimizer == "sgdm":
        return _sgdm(cfg)
    raise ValueError(cfg.optimizer)


def _master(values: dict) -> dict:
    # A copy even for f32 params: the master must not alias them.
    return {k: v.detach().to(torch.float32, copy=True) for k, v in values.items()}


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
            st["master"] = _master(values)
        return st

    def scalars(step):
        """The step's learning rate and bias corrections, 0-d f32 tensors."""
        t = _f32(step) + 1
        return _lr(step, cfg), 1 - b1**t, 1 - b2**t

    @torch.no_grad()
    def update(grads: dict, state: dict, values: dict, step, max_norm=math.inf):
        lr, c1, c2 = scalars(step)
        if cfg.master_fp32 and fused.takes(grads, values, state["m"], state["v"],
                                           state["master"]):
            return fused.clip_adamw_(grads, state["m"], state["v"], state["master"], values,
                                     lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps,
                                     weight_decay=cfg.weight_decay, max_norm=max_norm)
        grads, norm = clip_by_global_norm(grads, max_norm)
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
        return norm

    def state_axes(values_axes: dict) -> dict:
        st = {"m": values_axes, "v": values_axes}
        if cfg.master_fp32:
            st["master"] = values_axes
        return st

    return Optimizer(init, update, state_axes)


# --------------------------------------------------------------- Adafactor
def _adafactor(cfg: RunConfig, decay=0.8, eps=1e-30, clip_thresh=1.0):
    @torch.no_grad()
    def init(values: dict) -> dict:
        def vstate(v):
            f32 = {"dtype": torch.float32, "device": v.device}
            if v.ndim >= 2:
                return {"vr": torch.zeros(v.shape[:-1], **f32),
                        "vc": torch.zeros(v.shape[:-2] + v.shape[-1:], **f32)}
            return {"v": torch.zeros(v.shape, **f32)}

        st = {"v": {k: vstate(v) for k, v in values.items()}}
        if cfg.master_fp32:
            st["master"] = _master(values)
        return st

    @torch.no_grad()
    def update(grads: dict, state: dict, values: dict, step, max_norm=math.inf):
        grads, norm = clip_by_global_norm(grads, max_norm)
        lr = _lr(step, cfg)
        beta = 1.0 - (_f32(step) + 1) ** (-decay)
        for k, g in grads.items():
            p, vs = values[k], state["v"][k]
            g = g.float()
            g2 = g * g + eps
            if g.ndim >= 2:
                vr, vc = vs["vr"], vs["vc"]
                vr.mul_(beta).add_((1 - beta) * g2.mean(dim=-1))
                vc.mul_(beta).add_((1 - beta) * g2.mean(dim=-2))
                denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                vhat = (vr[..., None] / denom[..., None]) * vc[..., None, :]
                u = g / torch.sqrt(vhat + eps)
            else:
                v = vs["v"]
                v.mul_(beta).add_((1 - beta) * g2)
                u = g / torch.sqrt(v + eps)
            # RMS update clipping (Adafactor eq. 7), over the whole leaf.
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms / clip_thresh, min=1.0)
            master = state["master"][k] if cfg.master_fp32 else p.float()
            if p.ndim >= 2:
                u = u + cfg.weight_decay * master
            new = master - lr * u
            if cfg.master_fp32:
                master.copy_(new)
            p.copy_(new.to(p.dtype))
        return norm

    def state_axes(values_axes: dict) -> dict:
        def vaxes(a):
            if len(a) >= 2:
                return {"vr": a[:-1], "vc": a[:-2] + a[-1:]}
            return {"v": a}

        st = {"v": {k: vaxes(a) for k, a in values_axes.items()}}
        if cfg.master_fp32:
            st["master"] = values_axes
        return st

    return Optimizer(init, update, state_axes)


# -------------------------------------------------------------------- SGDM
def _sgdm(cfg: RunConfig, momentum=0.9):
    @torch.no_grad()
    def init(values: dict) -> dict:
        return {"mom": {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                        for k, v in values.items()},
                "master": _master(values)}

    @torch.no_grad()
    def update(grads: dict, state: dict, values: dict, step, max_norm=math.inf):
        grads, norm = clip_by_global_norm(grads, max_norm)
        lr = _lr(step, cfg)
        for k, g in grads.items():
            m, master = state["mom"][k], state["master"][k]
            m.mul_(momentum).add_(g.float())
            master.sub_(lr * m)
            values[k].copy_(master.to(values[k].dtype))
        return norm

    def state_axes(values_axes: dict) -> dict:
        return {"mom": values_axes, "master": values_axes}

    return Optimizer(init, update, state_axes)
