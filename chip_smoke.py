#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one Hopper card.

    python3 chip_smoke.py

Phases, each of which fails the run (exit 1, no result lines) if it fails:

1. environment: the card's name and power limit (nvidia-smi), versions;
2. build: the CUDA kernel from the sources in this checkout;
3. kernel parity: every kernel against its plain PyTorch version on the
   card, over the port's parity shapes plus the shapes the trainer gives
   it; exact for the integer gather. Times the kernel and the plain
   version on the device (a CUDA graph of 50 calls, CUDA events) and on
   the host (per call), and computes the bound from the inputs;
4. main path: ``repro_torch.launch.train`` at tinyllama-1.1b full width
   (22 layers, d_model 2048, 32/4 heads, vocab 32000, bf16), B=8, S=2048,
   ``--device-path gather --remat dots`` for 6 steps. Checks that the
   kernel ran once per staged batch, every loss is finite, the first loss
   is near ln(vocab), and the staged batches equal a second loader's host
   stream on the same spec; then profiles a 4-step run of the same path
   for the device's idle share and its heaviest kernels (and fails if the
   trace holds no device events or no gather kernel);
5. small-input reference: reduced tinyllama in f32 on the card against the
   same weights on the CPU (logits and one train step), TF32 off.

The last four lines are the main path's numbers as JSON, the card's name
and power limit, the kernel table as JSON, and ``{"ok": true, "device":
{...}}``. Exits non-zero without a card, and in a directory without the
port's sources.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

#: H100 SXM device memory rate (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
MAIN_ARGS = ["--arch", "tinyllama-1.1b", "--full", "--nodes", "2", "--batch", "8",
             "--seq-len", "2048", "--device-path", "gather", "--remat", "dots",
             "--steps", "6"]
SMALL_TOL = 1e-4  # f32 on the card vs the CPU: summation order only


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def graph_ms(fn, *, calls: int = 50, reps: int = 20) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, so no host code runs between the launches; the graph replayed
    ``reps`` times between CUDA events; the median replay over ``calls``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as capture requires
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / calls)
    return statistics.median(samples)


def host_ms(fn, *, calls: int = 50, reps: int = 20) -> float:
    """Host time per call of ``fn`` (checks, allocation, launch): the median
    over ``reps`` of ``calls`` back-to-back calls on the host clock."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        samples.append((time.perf_counter() - t0) / calls * 1e3)
        torch.cuda.synchronize()
    return statistics.median(samples)


def gather_bytes(slots, lens, idx, seq_len: int) -> tuple[int, int]:
    """Bytes ``chunk_gather_train`` must move on these inputs, and the
    number of distinct slot rows: ``idx`` read once, ``lens`` and the first
    ``min(lens[s], S + 1)`` tokens of each distinct selected row ``s`` read
    once, three (B, S) 4-byte outputs written once."""
    import torch

    rows = torch.unique(idx.long())
    row_tokens = int(lens[rows].long().clamp(max=seq_len + 1).sum())
    b = idx.numel()
    return b * 4 + rows.numel() * 4 + row_tokens * 4 + b * seq_len * 12, rows.numel()


def main_path(argv, *, batch: int, seq_len: int, vocab: int) -> dict:
    """Drive ``repro_torch.launch.train`` with ``argv``; check it; return
    its numbers, with the kernel's launches in the run (counts zeroed just
    before)."""
    import torch

    from repro_torch.core import ChunkStore, RedoxLoader
    from repro_torch.kernels.chunk_gather.ops import chunk_gather_train
    from repro_torch.launch.train import parse_args, train

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        args = parse_args(argv + ["--workdir", work])
        staged = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        chunk_gather_train.launches = 0
        summary = train(args, on_batch=lambda step, feed: staged.append(feed))
        launches = chunk_gather_train.launches
        peak = torch.cuda.max_memory_allocated()
        stats = summary["device_stats"]
        losses = summary["losses"]
        print(f"losses {losses}")
        print(f"tokens/sec {summary['tokens_per_s']:.1f} (whole run), "
              f"{summary['steady_tokens_per_s']:.1f} (steps 2-{len(losses)}); "
              f"max_memory_allocated {peak / 2**30:.2f} GiB; "
              f"overlap fraction {stats.overlap_fraction:.4f}; "
              f"{stats.bytes_to_device / 1e6:.3f} MB to device over {stats.steps} staged "
              f"batches; kernel launches {launches}")
        if launches == 0 or launches != stats.steps or launches != stats.kernel_steps:
            fail(f"kernel launches {launches} != staged batches {stats.steps}")
        if len(losses) != args.steps or not all(math.isfinite(x) for x in losses):
            fail(f"expected {args.steps} finite losses, got {losses}")
        if abs(losses[0] - math.log(vocab)) > 2.0:
            fail(f"first loss {losses[0]} is not near ln({vocab}) at random init")
        if len(staged) != args.steps:
            fail(f"the trainer saw {len(staged)} batches, expected {args.steps}")
        store = ChunkStore.open(Path(work) / "chunks")
        host = RedoxLoader.from_spec(summary["spec"], store).epoch(0)
        for i, (feed, ref) in enumerate(zip(staged, host)):
            for k in ("tokens", "targets", "loss_mask"):
                got = feed[k].cpu().numpy()
                if got.shape != (batch, seq_len) or not (got == ref[k]).all():
                    fail(f"staged {k} of step {i} differs from the host stream")
        store.close()
        print(f"staged batches equal the host stream ({len(staged)} steps)")
    return {
        "launches": launches, "losses": losses,
        "tokens_per_s": summary["tokens_per_s"],
        "steady_tokens_per_s": summary["steady_tokens_per_s"],
        "max_memory_allocated_gib": peak / 2**30,
        "overlap_fraction": stats.overlap_fraction,
        "mb_to_device": stats.bytes_to_device / 1e6, "staged_batches": stats.steps,
    }


def small_reference(device) -> None:
    """Reduced tinyllama in f32 on ``device`` against the same weights on
    the CPU: logits (dense and chunked attention) and one train step."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import RunConfig, get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.train_step import build_train_step, fresh_train_state

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (4, 129)).astype(np.int32)
    batch_np = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
                "loss_mask": (rng.random((4, 128)) < 0.9).astype(np.float32)}
    for threshold in (2048, 64):  # dense, then chunked attention
        cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")), attn_chunk=32,
                                  attn_dense_threshold=threshold)
        cpu_model = build_model(cfg, device="cpu").init(0)
        results = []
        for dev in ("cpu", device):
            model = build_model(cfg, device=dev)
            model.load_state_dict(cpu_model.state_dict())
            feed = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    for k, v in batch_np.items()}
            with torch.no_grad():
                logits = model(feed)[0].double().cpu()
            run = RunConfig()
            opt = make_optimizer(run)
            state = fresh_train_state(model, opt)
            _, m = build_train_step(model, run, opt)(state, feed)
            results.append((logits, float(m["loss"]), float(m["grad_norm"])))
        (lc, loss_c, gn_c), (lg, loss_g, gn_g) = results
        err = float((lg - lc).abs().max() / lc.abs().max())
        print(f"attn_dense_threshold {threshold}: logits err {err:.3e}, loss "
              f"{loss_g:.6f} vs {loss_c:.6f}, grad_norm {gn_g:.6f} vs {gn_c:.6f} "
              f"(tolerance {SMALL_TOL})")
        if not (err <= SMALL_TOL and abs(loss_g - loss_c) <= SMALL_TOL * abs(loss_c)
                and abs(gn_g - gn_c) <= SMALL_TOL * abs(gn_c)):
            fail(f"{device} disagrees with the CPU on the reduced model")


def where_time_goes(argv) -> dict:
    """Profile a short run of the main path; from the device timeline
    after the third step begins, return the device's idle share and the
    kernels that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.launch.train import parse_args, train

    def mark(step, feed):
        with record_function(f"chip_smoke.step{step}"):
            pass

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        args = parse_args(argv + ["--workdir", work, "--steps", "4"])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            train(args, on_batch=mark)  # ends in torch.cuda.synchronize()
        trace_file = Path(work) / "trace.json"
        prof.export_chrome_trace(str(trace_file))
        events = json.loads(trace_file.read_text())["traceEvents"]
    start = min((e["ts"] for e in events if e.get("name") == "chip_smoke.step2"),
                default=None)
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                    for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if start is None or not device:
        fail("the profiler trace has no step marker or no device events")
    end = max(d[1] for d in device)
    busy, cur_s, cur_e, by_name = 0.0, None, None, {}
    for s_, e_, name in device:
        s_, e_ = max(s_, start), min(e_, end)
        if e_ <= s_:
            continue
        by_name[name] = by_name.get(name, 0.0) + (e_ - s_)
        if cur_e is None or s_ > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += 0.0 if cur_e is None else cur_e - cur_s
    window = end - start
    idle = 1.0 - busy / window
    print(f"device window {window / 1e3:.1f} ms (steps 3-{args.steps}), busy "
          f"{busy / 1e3:.1f} ms, idle share {idle:.4f}")
    total = sum(by_name.values())
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {t / total:6.1%}  {t / 1e3:9.2f} ms  {name[:110]}")
    gather = sum(t for n, t in by_name.items() if "chunk_gather_train_kernel" in n)
    gathers = [e_ - s_ for s_, e_, name in device if "chunk_gather_train_kernel" in name]
    if not gathers:
        fail("the profiled main path shows no chunk_gather_train_kernel on the device")
    print(f"  chunk_gather_train_kernel: {gather / 1e3:.4f} ms of device time in the "
          f"window ({gather / total:.6%}); {len(gathers)} launches in the whole run, "
          f"{statistics.mean(gathers):.3f} us each")
    return {"idle_share": idle, "window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "gather_launches": len(gathers), "gather_us_each": statistics.mean(gathers)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"no port sources at {SRC / 'repro_torch'}")
    sys.path.insert(0, str(SRC))

    from repro_torch.kernels import build, parity
    from repro_torch.kernels.chunk_gather.ops import chunk_gather_train
    from repro_torch.kernels.chunk_gather.ref import chunk_gather_train_ref
    from repro_torch.kernels.common import resolve_device

    # ------------------------------------------------------------ 1. env
    phase("1. environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line)
    device = resolve_device()  # raises unless capability (9, 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)} "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------- 2. build
    phase("2. build")
    t0 = time.perf_counter()
    log = build.build("chunk_gather")
    print(f"built chunk_gather {'(cached) ' if log is None else ''}"
          f"in {time.perf_counter() - t0:.2f} s")
    for line in (log or "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  {line.strip()}")

    # ------------------------------------------------- 3. kernel parity
    phase("3. kernel parity (CUDA kernel vs plain PyTorch on the card)")
    seq_len, batch = 2048, 8
    trainer_case = parity.KernelCase("chunk_gather_train", (batch, seq_len, batch), "int32")
    kernels = []
    for case, row_pad in [(c, 128) for c in parity.iter_cases()] + [(trainer_case, 8)]:
        inputs = parity.make_inputs(case, device=device, row_pad=row_pad)
        got = parity.run_kernel(case, inputs)
        want = parity.run_ref(case, inputs)
        torch.cuda.synchronize()
        tol = parity.KERNELS[case.kernel]["tols"][case.dtype]
        abs_err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)) or abs_err > tol:
            fail(f"{case.name}: kernel disagrees with its plain version "
                 f"(max abs err {abs_err}, tolerance {tol})")
        print(f"{case.name} row_pad {row_pad}: equal (max abs err {abs_err})")
    # Time at the trainer's shapes (row_pad 8, as the stager packs).
    inputs = parity.make_inputs(trainer_case, device=device, row_pad=8)
    slot, lens, idx = inputs

    def kernel():
        return chunk_gather_train(slot, lens, idx, seq_len=seq_len)

    def plain():
        return chunk_gather_train_ref(slot, lens, idx, seq_len=seq_len)

    # Device time per call in a CUDA graph, in turns (plain, kernel, kernel,
    # plain) so drift hits both alike; then the host time per call.
    p_ms = graph_ms(plain)
    k_ms, k_ms2 = graph_ms(kernel), graph_ms(kernel)
    p_ms2 = graph_ms(plain)
    k_host, p_host = host_ms(kernel), host_ms(plain)
    moved, rows = gather_bytes(slot, lens, idx, seq_len)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    abs_err = max(float((g.double() - w.double()).abs().max())
                  for g, w in zip(kernel(), plain()))
    print(f"chunk_gather_train at B={batch} S={seq_len} Lp={slot.shape[1]}: device time "
          f"per call (CUDA graph of 50 calls, CUDA events): kernel {k_ms * 1e3:.3f} / "
          f"{k_ms2 * 1e3:.3f} us, plain {p_ms * 1e3:.3f} / {p_ms2 * 1e3:.3f} us; host time "
          f"per call: kernel {k_host * 1e3:.2f} us, plain {p_host * 1e3:.2f} us; bound "
          f"{bound_ms * 1e3:.4f} us ({moved} bytes, {rows} distinct slot rows, at 3.35 TB/s)")
    spec = parity.KERNELS["chunk_gather_train"]
    entry = {
        "name": "chunk_gather_train", "route": "cuda", "source": spec["source"],
        "replaces": spec["replaces"], "launches": None, "max_abs_err": abs_err,
        "ms": statistics.median([k_ms, k_ms2]), "plain_ms": statistics.median([p_ms, p_ms2]),
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
        "host_ms": k_host, "plain_host_ms": p_host,
    }
    kernels.append(entry)

    # ------------------------------------------------------ 4. main path
    phase("4. main path: repro_torch.launch.train " + " ".join(MAIN_ARGS))
    run = main_path(MAIN_ARGS, batch=batch, seq_len=seq_len, vocab=32000)
    entry["launches"] = run["launches"]
    torch.cuda.empty_cache()

    phase("4b. where the main path's device time goes (torch.profiler)")
    run["profile"] = where_time_goes(MAIN_ARGS)
    torch.cuda.empty_cache()

    # -------------------------------------- 5. small-input reference check
    phase("5. reduced tinyllama f32: card vs CPU on the same weights")
    small_reference(device)

    # ----------------------------------------------------------- result
    print(json.dumps({"main_path": run}))
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
