"""The gathers' edge grid: inputs at the edges of the CUDA kernels' two paths.

Each case is one call of ``chunk_gather_train`` or the raw ``chunk_gather``
whose expected output comes from ``ref.py``, exactly:

* both paths: the slot buffer is a view at element offset 0 (16-byte
  path, where the row lengths allow it) or 1, 2, 3 (scalar path);
* row lengths at the edges of a 4-token run, a warp and a block: S of 7,
  8, 13, 100, 1028 and 2048, with slot rows of ``round_up(S + 1, 8)``
  tokens as the trainer packs them (S = 7 gives Lp = S + 1, S = 100 gives
  Lp = S + 4, the tightest 16-byte case); raw rows L of 8, 100, 101, 1030
  and 2176;
* record lengths n of 0, 1, 3, 4, 5, S and S + 1 (raw: up to L), and
  slot rows filled past n, so a pad that is not written shows;
* duplicate indices and out-of-range slots (-1, U, 2**31 - 1), which the
  kernels answer with a padded, fully masked row (the host rejects them
  before any copy; ``with_empty_slot`` maps them to an extra empty slot).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..common import round_up
from .ops import chunk_gather, chunk_gather_train, vector_path
from .ref import chunk_gather_ref, chunk_gather_train_ref

__all__ = ["EdgeCase", "edge_cases", "expected", "run", "with_empty_slot"]

TRAIN_SEQ_LENS = (7, 8, 13, 100, 1028, 2048)
RAW_ROW_LENS = (8, 100, 101, 1030, 2176)
OFFSETS = (0, 1, 2, 3)
OUT_OF_RANGE = (-1, None, 2**31 - 1)  # None: U, one past the last slot


@dataclasses.dataclass(frozen=True)
class EdgeCase:
    """One call: ``seq_len`` None for the raw gather."""

    name: str
    inputs: tuple      # chunk_tokens (U, Lp) view, record_lens (U,), indices (B,)
    seq_len: int | None
    pad_id: int
    offset: int        # element offset of the slot view in its buffer

    @property
    def vector(self) -> bool:
        """The path the kernel takes: 16-byte (True) or scalar."""
        row_len = self.inputs[0].shape[1] if self.seq_len is None else self.seq_len
        return vector_path(self.inputs[0], row_len)


def _case(rng, device, *, seq_len, row_len, lens, offset) -> EdgeCase:
    u = len(lens)
    # A copy in PyTorch's own allocation, so offset 0 starts on 16 bytes.
    buf = torch.tensor(rng.integers(1, 1000, offset + u * row_len, dtype=np.int32),
                       device=device)
    slots = buf[offset:].view(u, row_len)
    order = rng.permutation(u)
    idx = [*order, *order[:3], *(u if s is None else s for s in OUT_OF_RANGE)]
    kind = "raw" if seq_len is None else f"train S={seq_len}"
    return EdgeCase(
        name=f"{kind} L={row_len} offset={offset}",
        inputs=(slots, torch.as_tensor(np.asarray(lens, np.int32), device=device),
                torch.as_tensor(np.asarray(idx, np.int32), device=device)),
        seq_len=seq_len, pad_id=3 * offset, offset=offset)


def edge_cases(device="cpu", seed: int = 0) -> list[EdgeCase]:
    """The grid on ``device``: every row length at every offset."""
    rng = np.random.default_rng(seed)
    cases = []
    for s in TRAIN_SEQ_LENS:
        lens = sorted({0, 1, 3, 4, 5, s, s + 1} & set(range(s + 2)))
        for off in OFFSETS:
            cases.append(_case(rng, device, seq_len=s, row_len=round_up(s + 1, 8), lens=lens,
                               offset=off))
    for length in RAW_ROW_LENS:
        lens = sorted({0, 1, 3, 4, 5, length - 1, length})
        for off in OFFSETS:
            cases.append(_case(rng, device, seq_len=None, row_len=length, lens=lens,
                               offset=off))
    return cases


def run(case: EdgeCase, *, in_range_only: bool = False) -> tuple:
    """The wrapper on the case's inputs (only the in-range rows if asked:
    on the CPU the wrapper rejects the others)."""
    slots, lens, idx = case.inputs
    if in_range_only:
        idx = idx[(idx >= 0) & (idx < slots.shape[0])]
    if case.seq_len is None:
        return chunk_gather(slots, lens, idx, pad_id=case.pad_id)
    return chunk_gather_train(slots, lens, idx, seq_len=case.seq_len, pad_id=case.pad_id)


def with_empty_slot(case: EdgeCase) -> tuple:
    """The case's inputs with one extra slot of length 0 and every
    out-of-range index pointed at it: the row the kernels write for such a
    slot is that slot's padded, fully masked row."""
    slots, lens, idx = case.inputs
    u = slots.shape[0]
    slots = torch.cat([slots, torch.zeros_like(slots[:1])])
    lens = torch.cat([lens, lens.new_zeros(1)])
    return slots, lens, torch.where((idx >= 0) & (idx < u), idx, u)


def expected(case: EdgeCase) -> tuple:
    """``ref.py`` on :func:`with_empty_slot`'s inputs."""
    slots, lens, idx = with_empty_slot(case)
    if case.seq_len is None:
        return chunk_gather_ref(slots, lens, idx, pad_id=case.pad_id)
    return chunk_gather_train_ref(slots, lens, idx, seq_len=case.seq_len, pad_id=case.pad_id)
