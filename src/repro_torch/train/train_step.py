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
The serving steps come with the serving slice.
"""

from __future__ import annotations

import torch

from ..configs.base import RunConfig
from ..models.common import flatten_tree
from ..models.transformer import Model
from ..optim.optimizers import Optimizer, clip_by_global_norm
from .losses import lm_loss

__all__ = ["build_train_step", "init_train_state"]

_BATCH_KEYS = ("tokens", "targets", "loss_mask")


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
        grads = torch.autograd.grad(loss, list(params.values()))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, dict(zip(params, grads))

    def compute_grads(params: dict, batch):
        k = run_cfg.microbatch
        if not (k and k > 1):
            return grad_fn(params, batch)
        micro = [
            {key: batch[key].reshape(k, batch[key].shape[0] // k, *batch[key].shape[1:])[i]
             for key in _BATCH_KEYS}
            for i in range(k)
        ]
        # Accumulate in the param dtype (bf16 for big models) unless a
        # grad dtype is forced, as the reference does.
        acc_dt = (getattr(torch, run_cfg.grad_allreduce_dtype)
                  if run_cfg.grad_allreduce_dtype else None)
        loss = torch.zeros((), dtype=torch.float32)
        grads = {p: torch.zeros(v.shape, dtype=acc_dt or v.dtype, device=v.device)
                 for p, v in params.items()}
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
