"""Input specs (meta-tensor stand-ins) and dummy inputs per (arch, shape)
(``repro/launch/specs.py``).

The dry run runs against the specs, on the meta device; smoke tests
materialise the dummy variants, drawn from numpy exactly as the reference
draws them, so the two packages' dummy inputs are equal bit for bit (bf16
included). For ``vlm`` the sequence is [patch positions | text]; for
``frame`` (audio) every position is a frame embedding and targets are the
masked-unit labels (HuBERT objective).
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig

__all__ = ["train_input_specs", "decode_input_specs", "dummy_train_inputs", "dummy_tokens"]

_F32 = torch.float32
_I32 = torch.int32


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Specs for train/prefill (full-sequence) steps."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.frontend == "patch":
        p = cfg.frontend_len
        assert p < s, (p, s)
        return {
            "tokens": _sds((b, s - p), _I32),
            "patch_embeds": _sds((b, p, cfg.frontend_dim), torch.bfloat16),
            "targets": _sds((b, s), _I32),
            "loss_mask": _sds((b, s), _F32),
        }
    if cfg.frontend == "frame":
        return {
            "frames": _sds((b, s, cfg.frontend_dim), torch.bfloat16),
            "targets": _sds((b, s), _I32),
            "loss_mask": _sds((b, s), _F32),
        }
    return {
        "tokens": _sds((b, s), _I32),
        "targets": _sds((b, s), _I32),
        "loss_mask": _sds((b, s), _F32),
    }


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b = shape.global_batch
    return {"tokens": _sds((b, 1), _I32), "cache_pos": _sds((), _I32)}


def dummy_tokens(rng: np.random.Generator, b: int, s: int, vocab: int) -> np.ndarray:
    return rng.integers(0, vocab, (b, s)).astype(np.int32)


def _as(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """numpy float64 -> ``dtype``, through float32 as the reference's cast."""
    return torch.from_numpy(np.asarray(arr, np.float32)).to(getattr(torch, dtype))


def dummy_train_inputs(cfg: ModelConfig, b: int, s: int, seed: int = 0) -> dict:
    """Materialised random inputs matching train_input_specs (CPU tensors)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "patch":
        p = cfg.frontend_len
        return {
            "tokens": torch.from_numpy(dummy_tokens(rng, b, s - p, cfg.vocab_size)),
            "patch_embeds": _as(rng.normal(size=(b, p, cfg.frontend_dim)), cfg.compute_dtype),
            "targets": torch.from_numpy(dummy_tokens(rng, b, s, cfg.vocab_size)),
            "loss_mask": torch.from_numpy(
                np.concatenate(
                    [np.zeros((b, p), np.float32), np.ones((b, s - p), np.float32)], 1
                )
            ),
        }
    if cfg.frontend == "frame":
        mask = (rng.random((b, s)) < 0.08).astype(np.float32)  # HuBERT-style 8%
        return {
            "frames": _as(rng.normal(size=(b, s, cfg.frontend_dim)), cfg.compute_dtype),
            "targets": torch.from_numpy(dummy_tokens(rng, b, s, cfg.vocab_size)),
            "loss_mask": torch.from_numpy(mask),
        }
    toks = dummy_tokens(rng, b, s + 1, cfg.vocab_size)
    return {
        "tokens": torch.from_numpy(toks[:, :-1].copy()),
        "targets": torch.from_numpy(toks[:, 1:].copy()),
        "loss_mask": torch.ones((b, s), dtype=torch.float32),
    }
