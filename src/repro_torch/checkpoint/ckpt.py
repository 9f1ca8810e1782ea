"""Checkpointing in the reference's on-disk format (``repro/checkpoint/ckpt.py``).

Format: ``step_<8 digits>/state.npz`` holding every leaf of the state
tree keyed by its tree path (``values/segments/0/attn/wq``,
``opt/m/...``, ``step``) plus a ``manifest.json``; a checkpoint is
written under ``.tmp_step_*`` and published by an atomic rename.

Checkpoints cross between the packages both ways. bfloat16 is the one
catch: numpy has no bf16, so a bf16 leaf the reference saves reads back
as raw ``|V2`` bytes, which :func:`restore_checkpoint` reinterprets bit
for bit. The port writes its bf16 leaves widened to float32, which is
exact and which numpy, and so the reference's restore, casts back to
bf16 exactly (it cannot cast ``|V2``, not even its own).

``AsyncCheckpointer`` copies the state to host memory on the caller's
thread, then writes on a worker thread and keeps the newest ``keep``.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..models.common import flatten_tree
from ..models.convert import from_numpy

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint", "save_checkpoint"]


def _host_leaf(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            t = t.float()  # exact; see the module docstring
        return t.numpy().copy()
    return np.asarray(x)


def _host_state(state) -> dict:
    return {k: _host_leaf(v) for k, v in flatten_tree(state).items()}


def _write(ckpt_dir: Path, step: int, arrays: dict) -> Path:
    path = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        np.savez(tmp / "state.npz", **arrays)
        manifest = {
            "step": int(step),
            "time": time.time(),
            "num_leaves": len(arrays),
            "keys": sorted(arrays),
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        # atomic publish: a checkpoint is visible only when complete
        if path.exists():
            raise FileExistsError(path)
        tmp.rename(path)
    except BaseException:
        # An abandoned save must not leave a half-written .tmp_step_* behind.
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def save_checkpoint(ckpt_dir: "str | Path", step: int, state) -> Path:
    return _write(Path(ckpt_dir), step, _host_state(state))


def latest_step(ckpt_dir: "str | Path") -> "int | None":
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in ckpt_dir.iterdir()
        if p.name.startswith("step_") and (p / "manifest.json").exists()
    ]
    return max(steps) if steps else None


@torch.no_grad()
def restore_checkpoint(ckpt_dir: "str | Path", step: int, state_like):
    """Restore into ``state_like`` in place: every tensor leaf is
    overwritten with the saved leaf of the same path (cast to its dtype,
    bf16 bits kept exact). Returns ``state_like``."""
    path = Path(ckpt_dir) / f"step_{step:08d}"
    with np.load(path / "state.npz") as z:
        arrays = {k: z[k] for k in z.files}
    for key, like in flatten_tree(state_like).items():
        arr = arrays[key]
        if arr.shape != tuple(like.shape):
            raise ValueError(f"{key}: saved shape {arr.shape} != {tuple(like.shape)}")
        like.copy_(from_numpy(arr).to(like.dtype))
    return state_like


class AsyncCheckpointer:
    """Fire-and-forget checkpoint writes on a worker thread."""

    def __init__(self, ckpt_dir: "str | Path", keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: "threading.Thread | None" = None
        self._error: "Exception | None" = None

    def save(self, step: int, state) -> None:
        self.wait()
        host_state = _host_state(state)

        def work():
            try:
                _write(self.ckpt_dir, step, host_state)
                self._gc()
            except Exception as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(
            int(p.name.split("_")[1])
            for p in self.ckpt_dir.iterdir()
            if p.name.startswith("step_")
        )
        for s in steps[: -self.keep]:
            target = self.ckpt_dir / f"step_{s:08d}"
            for f in target.iterdir():
                f.unlink()
            target.rmdir()
