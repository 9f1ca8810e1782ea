"""Training losses: causal LM CE (+ z-loss) (``repro/train/losses.py``)."""

from __future__ import annotations

import torch

__all__ = ["lm_loss"]


def lm_loss(logits, targets, loss_mask, *, aux=0.0, aux_weight=0.0, z_weight=1e-4):
    """Masked token-level cross entropy in fp32.

    logits: (B, S, V); targets: (B, S) int; loss_mask: (B, S) float.
    The z-loss ``mean(logz²)`` over the mask is added at ``z_weight``.
    """
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    denom = torch.clamp(loss_mask.sum(), min=1.0)
    ce = (nll * loss_mask).sum() / denom
    zl = ((logz * logz) * loss_mask).sum() / denom
    total = ce + z_weight * zl + aux_weight * aux
    aux_t = torch.as_tensor(aux, dtype=torch.float32, device=logits.device)
    return total, {"ce": ce, "z_loss": zl, "aux": aux_t}
