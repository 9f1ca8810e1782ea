"""End-to-end example on the PyTorch/CUDA port: train a ~100M-param LM with
the Redox data path.

The twin of ``examples/train_lm.py``, on ``repro_torch``: the same presets,
data recipe, optimizer, checkpoints and printed lines. The dataset is
materialised to chunk files on disk, the Redox cluster serves redirected
batches, the model trains with the full train step (AdamW, remat, grad
clip), and checkpoints are written in the shared format, so a run resumes
from a checkpoint that either example wrote. With ``--device-path gather``
each batch is assembled on the card by the CUDA ``chunk_gather_train``
kernel.

Runs on the CUDA card (a capability-9.0 one) unless ``--device cpu`` is
given; without a card it refuses instead of falling back to the CPU. The
model stays in float32, as the reduced config sets it. Where the reference
jits the train step with the state donated, on the card the step is one
replay of a CUDA graph that captured it at the first step
(``train_step.GraphTrain``), the state updated in place.

    PYTHONPATH=src python examples/train_lm_torch.py --preset 100m --device-path gather
    PYTHONPATH=src python examples/train_lm_torch.py --steps 12 --preset small --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.checkpoint.ckpt import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.configs import ARCHS, RunConfig, reduced
from repro_torch.core import Cluster, EpochSampler, RedoxLoader
from repro_torch.data import SyntheticTokenDataset
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.cli import add_device_args, add_storage_args
from repro_torch.models import build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.train_step import build_train_step, init_train_state

PRESETS = {
    # ~100M params: d=768, L=12, ff=3072, vocab=32000 (GPT-2-small-ish)
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 d_ff=3072, vocab_size=32000, head_dim=64, num_docs=8192,
                 batch=8, seq=512),
    "small": dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
                  d_ff=768, vocab_size=2048, head_dim=64, num_docs=1024,
                  batch=8, seq=128),
}

FEED_KEYS = ("tokens", "targets", "loss_mask")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--preset", default="small", choices=list(PRESETS))
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--workdir", default=None)
    add_storage_args(ap)
    add_device_args(ap)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model trains and batches are staged "
                         "(cuda needs a capability-9.0 card)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse; a missing card is a usage error (exit 2) unless ``--device cpu``."""
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    return args


def preset_config(preset: str):
    """The preset's tinyllama-family config (float32, as ``reduced`` sets it)."""
    p = PRESETS[preset]
    return dataclasses.replace(
        reduced(ARCHS["tinyllama-1.1b"]),
        num_layers=p["num_layers"], d_model=p["d_model"], num_heads=p["num_heads"],
        num_kv_heads=p["num_kv_heads"], d_ff=p["d_ff"], vocab_size=p["vocab_size"],
        head_dim=p["head_dim"], attn_dense_threshold=p["seq"],
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_loader(store, preset: str, nodes: int):
    """The example's Redox cluster and loader over ``store``."""
    p = PRESETS[preset]
    cluster = Cluster(store.plan, nodes, store=store, seed=2,
                      remote_memory_limit_bytes=1_000_000)
    sampler = EpochSampler(p["num_docs"], nodes, seed=3)
    loader = RedoxLoader(cluster, sampler, batch_per_node=p["batch"] // nodes or 1,
                         seq_len=p["seq"])
    return cluster, loader


def train(args: argparse.Namespace, *, on_batch=None, store=None) -> dict:
    """The example's run for parsed ``args``.

    ``on_batch(step, feed)``, when given, sees every batch just before its
    train step. ``store``, when given, is an open chunk store built by an
    earlier run of the same preset, used instead of building one. Returns
    ``losses`` (every step of this run), ``steps`` (run here),
    ``tokens_per_s`` (whole run, as printed) and ``steady_tokens_per_s``
    (after the run's first step), ``ckpt_s`` (the loop's time in checkpoint
    saves and the last wait), the stager's ``device_stats`` (None on the
    naive path), the ``start`` step it resumed from and the ``store``."""
    device = resolve_device(args.device)
    p = PRESETS[args.preset]
    cfg = preset_config(args.preset)
    workdir = Path(args.workdir or tempfile.mkdtemp(prefix="redox_train_"))
    print(f"workdir: {workdir}")

    # --- data: real chunk store on disk, Redox cluster, loader -------------
    if store is None:
        ds = SyntheticTokenDataset(p["num_docs"], cfg.vocab_size, mean_len=p["seq"] // 2,
                                   seed=5)
        store = ds.build_store(workdir / "chunks", chunk_size=16,
                               memory_bytes=ds.sizes_bytes.sum() // 4, seed=1,
                               backend=args.backend or "vfs",
                               codec=args.codec, bands=args.bands)
    if args.fidelity is not None:
        store.default_fidelity = args.fidelity
    print(f"storage backend: {store.backend.name} "
          f"(codec {store.spec.codec}, {store.spec.bands} band(s))")
    cluster, loader = build_loader(store, args.preset, args.nodes)

    # --- model + train step -------------------------------------------------
    model = build_model(cfg, device=device)
    n_params = cfg.param_count()
    print(f"model: {cfg.name}-derived, {n_params/1e6:.1f}M params")
    run = RunConfig(optimizer="adamw", learning_rate=3e-4, remat="dots")
    opt = make_optimizer(run)
    state = init_train_state(model, opt, seed=0)
    step_fn = build_train_step(model, run, opt)

    stager = None
    if args.device_path != "naive":
        from repro_torch.core.device import DeviceStager

        stager = DeviceStager(device=device, depth=args.stage_depth,
                              use_kernel=(args.device_path == "gather"))
        print(f"device path: {args.device_path} (depth {args.stage_depth})")

    def epoch_batches(epoch):
        if args.device_path == "gather":
            return loader.epoch_device(epoch, stager)
        if args.device_path == "stage":
            return stager.stream(loader.epoch_async(epoch))
        return loader.epoch_async(epoch)

    ckpt = AsyncCheckpointer(workdir / "ckpt", keep=2)
    start = latest_step(workdir / "ckpt")
    if start:
        restore_checkpoint(workdir / "ckpt", start, state)  # in place
        print(f"resumed from step {start}")

    # --- loop ----------------------------------------------------------------
    step = int(start or 0)
    epoch = 0
    losses = []
    t_first = None
    ckpt_s = 0.0  # the loop's own time in checkpoint saves (host copy, waits)
    _sync(device)
    t0 = time.time()
    while step < args.steps:
        for batch in epoch_batches(epoch):
            if step >= args.steps:
                break
            feed = {k: torch.as_tensor(batch[k]).to(device) for k in FEED_KEYS}
            if on_batch is not None:
                on_batch(step, feed)
            state, metrics = step_fn(state, feed)
            losses.append(metrics["loss"].clone())  # the step may reuse its buffers
            step += 1
            if t_first is None:
                _sync(device)
                t_first = time.time()
            if step % 20 == 0 or step == 1:
                dt = time.time() - t0
                io = batch["io_by_node"]
                loads = sum(x.chunk_loads for x in io.values())
                print(
                    f"step {step:4d} epoch {epoch} loss {float(metrics['loss']):.4f} "
                    f"gnorm {float(metrics['grad_norm']):.2f} "
                    f"({dt/step:.2f}s/step, chunk loads this step: {loads})"
                )
            if step % args.ckpt_every == 0:
                t_save = time.time()
                ckpt.save(step, state)
                ckpt_s += time.time() - t_save
        epoch += 1
    t_save = time.time()
    ckpt.wait()
    ckpt_s += time.time() - t_save
    _sync(device)
    t_end = time.time()
    elapsed = t_end - t0
    steps_run = step - int(start or 0)
    toks_per_step = p["batch"] * p["seq"]
    summary = dict(
        losses=[float(x) for x in losses], steps=steps_run, start=int(start or 0),
        ckpt_s=ckpt_s,
        tokens_per_s=steps_run * toks_per_step / max(elapsed, 1e-9),
        steady_tokens_per_s=((steps_run - 1) * toks_per_step / max(t_end - t_first, 1e-9)
                             if steps_run > 1 else None),
        device_stats=None, store=store,
    )
    if stager is not None:
        stager.close()
        d = summary["device_stats"] = stager.stats
        print(f"device path {args.device_path}: staged {d.steps} batches "
              f"({d.bytes_to_device / 1e6:.1f} MB to device), "
              f"overlap fraction {d.overlap_fraction:.2f}")
    if steps_run:
        print(f"throughput: {summary['tokens_per_s']:,.0f} tokens/sec "
              f"over {steps_run} step(s)")
    st = cluster.nodes[0].stats
    print(
        f"done: {step} steps; epoch-0 node-0 stats: hits={st.local_hits} "
        f"misses={st.memory_misses} fill_rate={st.mean_fill_rate:.2f}"
    )
    return summary


def main(argv=None) -> dict:
    """The example's run; returns :func:`train`'s summary."""
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
