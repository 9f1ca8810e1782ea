"""Training launcher: ``--arch <id>`` selects an architecture (``repro/launch/train.py``).

Runs on the CUDA card by default (``--device cpu`` for the CPU); a missing
or non-Hopper card is an error, never a silent CPU run. The model runs at
the reduced (same-family) size unless ``--full``; data always flows
through the real Redox chunk store and redirection protocol, and with
``--device-path gather`` each global batch is assembled on the card by the
CUDA ``chunk_gather_train`` kernel.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --full --device-path gather --batch 8 --seq-len 2048 --steps 6

With ``--data-server SOCKET`` the trainer owns no data plane at all: it
opens a session on a running ``repro_torch.launch.data_service --serve``
process and consumes batches from the shared-memory ring (DESIGN.md §11).
With ``--autotune`` the freshly built store is calibrated and reopened
with the backend and readahead the §6 time model picks (DESIGN.md §14).

A stub-frontend arch trains on the same token grids, its inputs built on
the card after staging (``_feed``): hubert-xlarge on one-hot frames,

    PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge \
        --full --device-path gather --batch 8 --seq-len 2048 --optimizer adafactor

and llava-next-34b on zero patch embeddings before the tokens.

The parser is built from the same ``cli.py`` builders as the reference's,
so every flag is spelled the same.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..checkpoint.ckpt import AsyncCheckpointer, latest_step, restore_checkpoint
from ..configs import RunConfig, get_config, list_archs, reduced
from ..core import ChunkStore, RedoxLoader, SessionSpec
from ..core.stats import PipelineTimeModel, StepIO
from ..data import SyntheticTokenDataset
from ..kernels.common import resolve_device
from ..models import build_model
from ..obs import MetricsRegistry, attribution, format_report, model_columns, trace
from ..optim.optimizers import make_optimizer
from ..service.transport import RedoxClient
from ..train.train_step import build_train_step, init_train_state
from .cli import (
    RESUME_AUTO,
    add_autotune_args,
    add_data_plane_args,
    add_device_args,
    add_elastic_args,
    add_obs_args,
)

__all__ = ["build_parser", "main", "parse_args", "train"]

_FEED_KEYS = ("tokens", "targets", "loss_mask")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--full", action="store_true", help="full-size config (real HW)")
    add_data_plane_args(ap, batch=8, seq_len=128, num_docs=1024)
    add_device_args(ap)
    add_elastic_args(ap)
    add_autotune_args(ap)
    add_obs_args(ap)
    ap.add_argument("--data-server", metavar="SOCKET", default=None,
                    help="consume batches from a repro_torch.launch.data_service "
                         "--serve process at this unix socket instead of "
                         "building a local data plane")
    ap.add_argument("--job-id", default="train0",
                    help="session id on the data server (--data-server only)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model trains and batches are staged "
                         "(cuda needs a capability-9.0 card)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse and validate; usage errors exit with status 2."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.data_server is not None and args.resume_data is not None:
        ap.error("--resume-data belongs to the server with --data-server "
                 "(run data_service --resume-data there)")
    if args.data_server is not None and args.suspend_after is not None:
        ap.error("--suspend-after belongs to the server with --data-server")
    if args.suspend_after is not None and args.resume_data is None:
        ap.error("--suspend-after requires --resume-data")
    if args.data_server is not None and args.device_path == "gather":
        ap.error("--device-path gather requires a local data plane (ring "
                 "frames ship assembled grids); use --device-path stage")
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    return args


#: Nominal NAS storage/network profile for the DESIGN §6 model columns
#: printed next to the measured attribution under ``--trace`` (as in the
#: reference launcher).
TRACE_TIME_MODEL = PipelineTimeModel(
    disk_bw=200e6, file_overhead=8e-3, chunk_overhead=8e-3,
    net_bw=1e9, net_latency=2e-4,
)


def _local_metrics(loader, store, stager) -> MetricsRegistry:
    """Registry over a local data plane's live stats objects."""
    reg = MetricsRegistry()
    if store is not None:
        reg.register_stats("backend", lambda: store.backend_stats)
    if stager is not None:
        reg.register_stats("device", lambda: stager.stats)
    cluster = getattr(loader, "cluster", None)
    if cluster is not None:
        for r, node in enumerate(cluster.nodes):
            reg.register_stats(
                "node", lambda n=node: n.stats, labels={"node": str(r)}
            )
    last_plan = getattr(loader, "last_plan", None)
    if last_plan is not None:
        reg.register_stats("planner", lambda: last_plan.stats)
    return reg


def _feed(batch, device, cfg) -> dict:
    """The train step's inputs on ``device`` (staged batches already are),
    with a stub-frontend arch's inputs built there from the token grid, as
    the reference launcher builds them: ``frame`` feeds one-hot frames of
    ``tokens % frontend_dim`` in place of the tokens; ``patch`` feeds zero
    patch embeddings before them, and its targets and loss mask gain
    ``frontend_len`` leading zeros."""
    out = {}
    for k in _FEED_KEYS:
        v = batch[k]
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = v.to(device)
    cdt = getattr(torch, cfg.compute_dtype)
    if cfg.frontend == "frame":
        tokens = out.pop("tokens")
        out["frames"] = F.one_hot((tokens % cfg.frontend_dim).long(),
                                  cfg.frontend_dim).to(cdt)
    elif cfg.frontend == "patch":
        b, p = out["tokens"].shape[0], cfg.frontend_len
        out["patch_embeds"] = torch.zeros((b, p, cfg.frontend_dim), dtype=cdt, device=device)
        for k in ("targets", "loss_mask"):
            out[k] = torch.cat([out[k].new_zeros((b, p)), out[k]], dim=1)
    return out


def train(args: argparse.Namespace, *, on_batch=None) -> dict:
    """Run the launcher's training loop for parsed ``args``.

    ``on_batch(step, feed)``, when given, sees every batch just before its
    train step. Returns a summary: per-step ``losses``, ``steps``,
    ``tokens_per_s`` (whole run) and ``steady_tokens_per_s`` (after the
    first step), the stager's ``device_stats``, the ``spec`` of the data
    plane (with ``--data-server``, the server's echo of it) and the
    ``workdir``, the autotuner's ``autotune`` choice (None without
    ``--autotune``), and ``elapsed_s``.
    """
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    tracer = trace.enable(args.trace_capacity) if args.trace else None

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    model = build_model(cfg, device=device)
    run = RunConfig(optimizer=args.optimizer, remat=args.remat)
    opt = make_optimizer(run)
    state = init_train_state(model, opt, 0)
    step_fn = build_train_step(model, run, opt)
    print(f"arch={args.arch} family={cfg.family} params={cfg.param_count():,d} "
          f"device={device}")

    workdir = Path(args.workdir or tempfile.mkdtemp(prefix=f"redox_{args.arch}_"))
    # Seeds derive from --seed exactly as in the reference launchers:
    # protocol +2, sampler +3, dataset +5.
    spec = SessionSpec(
        policy=args.policy,
        seed=args.seed + 2,
        sampler_seed=args.seed + 3,
        num_nodes=args.nodes,
        batch_per_node=max(args.batch // args.nodes, 1),
        seq_len=args.seq_len,
        engine=args.engine,
        remote_memory_limit_bytes=1_000_000,
        fidelity=args.fidelity,
    )
    data_dir = None
    if args.resume_data is not None:
        data_dir = (workdir / "ckpt" / "data" if args.resume_data == RESUME_AUTO
                    else Path(args.resume_data))
    store = None
    choice = None
    if args.data_server is not None:
        loader = RedoxClient(args.data_server, spec, job_id=args.job_id)
        spec = loader.spec
        print(f"data plane: {args.data_server} (job {args.job_id})")
    else:
        ds = SyntheticTokenDataset(args.num_docs, args.vocab_size or cfg.vocab_size,
                                   mean_len=args.seq_len // 2, seed=args.seed + 5)
        store = ds.build_store(workdir / "chunks", chunk_size=16,
                               memory_bytes=int(ds.sizes_bytes.sum() // 4),
                               seed=args.seed + 1,
                               codec=args.codec, bands=args.bands)
        if args.backend is not None:
            store.close()
            store = ChunkStore.open(workdir / "chunks", backend=args.backend)
        elif args.autotune:
            # Calibrate the freshly built store and reopen it with the
            # model-selected backend + readahead (DESIGN.md §14). An
            # explicit --backend wins over the autotuner (branch above).
            from .. import autotune
            from ..core.storage import make_backend

            steps_hint = max(args.num_docs // max(args.batch, 1), 1)
            _, choice = autotune.tune_store(
                workdir / "chunks",
                compute_per_step_s=args.compute_per_step,
                num_steps=steps_hint,
                memory_limit_bytes=(
                    int(args.autotune_memory_mb * 1e6)
                    if args.autotune_memory_mb is not None else None
                ),
            )
            print(f"autotune: {choice.describe()}")
            store.close()
            kwargs = {"readahead": choice.readahead} if choice.readahead else {}
            store = ChunkStore.open(
                workdir / "chunks",
                backend=make_backend(choice.backend, **kwargs),
            )
            # The §6 model's fidelity call on a progressive store — an
            # explicit --fidelity wins (it's already in the spec).
            if args.fidelity is None and choice.fidelity is not None:
                spec = dataclasses.replace(spec, fidelity=choice.fidelity)
        if data_dir is not None and (data_dir / "loader_manifest.json").exists():
            loader = RedoxLoader.resume(data_dir, store)
            print(f"data plane resumed at epoch {loader.resume_point[0]} "
                  f"step {loader.resume_point[1]}")
        else:
            loader = RedoxLoader.from_spec(spec, store)
    stager = None
    if args.device_path != "naive":
        from ..core.device import DeviceStager

        stager = DeviceStager(device=device, depth=args.stage_depth,
                              use_kernel=(args.device_path == "gather"))
        mode = f"device path: {args.device_path} (depth {args.stage_depth}"
        if args.device_path == "gather":
            mode += ", CUDA kernel gather" if cuda else ", plain torch gather"
        print(mode + ")")

    def epoch_batches(epoch):
        if args.device_path == "gather":
            return loader.epoch_device(epoch, stager)
        if args.device_path == "stage":
            return stager.stream(loader.epoch_async(epoch))
        return loader.epoch_async(epoch)

    ckpt = AsyncCheckpointer(workdir / "ckpt")
    start = latest_step(workdir / "ckpt")
    if start:
        restore_checkpoint(workdir / "ckpt", start, state)
        print(f"resumed from step {start}")

    if cfg.frontend != "none":
        print("note: stub-frontend arch — launcher trains on token records "
              "projected through the frontend stub")

    step = int(start or 0)
    run_steps = 0
    losses = []
    io_grid = [[] for _ in range(spec.num_nodes)] if tracer is not None else None
    suspended = False
    t_first = None
    epoch, t0 = (loader.resume_point or (0, 0))[0], time.time()
    while step < args.steps and not suspended:
        for batch in epoch_batches(epoch):
            if step >= args.steps:
                break
            feed = _feed(batch, device, cfg)
            if on_batch is not None:
                on_batch(step, feed)
            if tracer is None:
                state, metrics = step_fn(state, feed)
            else:
                # Force the step inside the span so "compute" reflects real
                # device time, not the enqueue (tracing is opt-in, so the
                # pipeline bubble this sync adds is acceptable).
                with trace.span("train.step", "compute", step=step):
                    state, metrics = step_fn(state, feed)
                    if cuda:
                        torch.cuda.synchronize(device)
            losses.append(metrics["loss"].clone())  # the step may reuse its buffers
            if io_grid is not None:
                by_node = batch.get("io_by_node") or {}
                for r in range(spec.num_nodes):
                    io_grid[r].append(by_node.get(r, StepIO()))
            step += 1
            run_steps += 1
            if step % 10 == 0 or step == 1:
                print(f"step {step:4d} loss {float(metrics['loss']):.4f} "
                      f"({(time.time()-t0)/step:.2f}s/step)")
            if run_steps == 1:
                t_first = time.time()  # the print above synchronised
            if step % args.ckpt_every == 0:
                ckpt.save(step, state)
                if data_dir is not None:
                    loader.suspend(data_dir)
            if args.suspend_after is not None and run_steps >= args.suspend_after:
                ckpt.save(step, state)
                loader.suspend(data_dir)
                suspended = True
                break
        epoch += 1
    ckpt.wait()
    if cuda:
        torch.cuda.synchronize(device)
    t_end = time.time()
    elapsed = t_end - t0
    losses = [float(x) for x in losses]
    toks_per_step = spec.num_nodes * spec.batch_per_node * spec.seq_len
    summary = dict(
        losses=losses, steps=run_steps, elapsed_s=elapsed,
        tokens_per_s=run_steps * toks_per_step / max(elapsed, 1e-9),
        steady_tokens_per_s=(
            (run_steps - 1) * toks_per_step / max(t_end - t_first, 1e-9)
            if run_steps > 1 else None
        ),
        device_stats=None, spec=spec, workdir=workdir, device=str(device),
        autotune=choice,
    )
    if stager is not None:
        stager.close()
        d = stager.stats
        summary["device_stats"] = d
        print(f"device path {args.device_path}: staged {d.steps} batches "
              f"({d.bytes_to_device / 1e6:.1f} MB to device), "
              f"overlap fraction {d.overlap_fraction:.2f}")
    if run_steps:
        print(f"throughput: {summary['tokens_per_s']:,.0f} tokens/sec "
              f"over {run_steps} step(s)")
    if args.metrics:
        if args.data_server is not None:
            print(loader.metrics()["text"], end="")  # server-side registry
        else:
            print(_local_metrics(loader, store, stager).exposition(), end="")
    if tracer is not None:
        out = tracer.dump(args.trace)
        print(f"trace: {len(tracer)} events ({tracer.dropped} dropped) -> "
              f"{out}; open in the Perfetto UI or chrome://tracing")
        att = attribution(tracer.events(), wall_s=elapsed)
        cols = None
        if run_steps and any(io_grid):
            cols = model_columns(
                io_grid, TRACE_TIME_MODEL,
                att["busy_s"].get("compute", 0.0) / run_steps,
            )
        print(format_report(att, model=cols, measured_wall_s=elapsed))
        trace.disable()
    if args.data_server is not None:
        loader.close()
    if store is not None:
        store.close()
    if suspended:
        print(f"suspended after {run_steps} step(s) -> {data_dir}; "
              f"rerun with the same flags to continue")
    else:
        print(f"done: {step} steps in {elapsed:.0f}s; workdir={workdir}")
    return summary


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
