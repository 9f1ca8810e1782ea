#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one Hopper card.

    python3 chip_smoke.py

Phases, each of which fails the run (exit 1, no result lines) if it fails,
and each of which prints its wall time:

1. environment: the card's name and power limit (nvidia-smi), versions;
2. build: the four CUDA kernel packages (chunk_gather, flash_attention,
   decode_attention, ssd_scan) from the sources in this checkout, one nvcc
   each, all started together;
3. kernel parity: every kernel against its plain PyTorch version on the
   card, over the port's parity grid, edge cases and the shapes the main
   paths give it: exact for the two integer gathers, the registry's
   scale-normalised tolerance for the attention kernels (f32 2e-5, bf16
   2e-2) and the SSD scan (f32 2e-4, bf16 5e-2). The attention edge cases
   sit at the kernels' tile edges: flash at S 1-257 with windows of
   127-129 (first kv tiles fully masked), D 32/64/128, G 1/4/8, causal and
   not; decode at G 1-16 with a split and an unsplit cache, a ring mask
   that wraps and a fully masked row; and each attention kernel run twice
   and replayed three times in a CUDA graph, bit for bit equal (their
   self-resetting counters: flash's work items, decode's split merge).
   ssd_scan at its bf16 kernel's edges: H of 1, G - 1, G, G + 1 and 65
   (G heads a block), S of 1-257 across the 64-step tile, (P, N) padded
   to 64 with copies of 16 (TMA), 8 and 4 bytes, with and without an
   initial state, contiguous and strided, bf16 and f32; a bf16 x at an odd
   element offset must raise; and the same replay check.
   Times each kernel, its plain version and, where one exists, the PyTorch
   library call computing the same function on the device (a CUDA graph
   of many calls, CUDA events), and computes its bound from the inputs.
   The two gathers also run over their edge grid (``chunk_gather/
   edges.py``: 16-byte and scalar paths, slot views at offsets 0-3, rows
   at run, warp and block edges, n of 0, 1, 3, 4, 5, S and S + 1,
   out-of-range slots) and a replay check on each path; their times at
   B = 8 print beside the launch floor (a one-element ``fill_`` in the
   same harness), with host time per call, and ``chunk_gather_train``
   is timed at the large shape (``train_4k`` as one batch: B = U = 256,
   S = 4096) against its bytes bound, rotating 8 input sets and keeping
   every output so that no call finds its bytes in the L2;
4. training main path: ``repro_torch.launch.train`` at tinyllama-1.1b
   full width (22 layers, d_model 2048, 32/4 heads, vocab 32000, bf16),
   B=8, S=2048, ``--device-path gather --remat dots`` for 6 steps. Checks
   that the gather kernel ran once per staged batch, every loss is finite,
   the first loss is near ln(vocab), and the staged batches equal a second
   loader's host stream; then profiles a 4-step run for the device's idle
   share and its heaviest kernels (fails if the trace holds no device
   events or no gather kernel, or unless each staged batch is 2 device
   operations on the stager's side stream: one copy and the gather);
5. serving main path: ``repro_torch.launch.serve`` at tinyllama-1.1b full
   width, B=8, a 1920-token prompt, 128 new tokens. Checks 22 flash and
   22 x 127 decode launches, tokens in range, finite logits, and decode
   against a fresh prefill at four positions (scale-normalised error <=
   5e-2 and argmax agreeing on 7 of 8 rows); then profiles 16 decode steps
   for the device's idle share and its heaviest kernels (fails if the
   trace holds no device events or no decode kernel);
6. small-input reference: reduced tinyllama in f32 on the card against the
   same weights on the CPU, TF32 off: logits and one train step, and
   prefill + greedy decode with a full, a rotating-window and an int8
   cache; reduced zamba2 the same way, with a full cache and a window the
   prompt overfills;
7. hybrid serving main path: ``repro_torch.launch.serve`` at zamba2-1.2b
   full width (38 Mamba-2 blocks, d_model 2048, 64 SSM heads of 64, state
   64; the shared attention+MLP block, 32/32 heads, at 6 sites; vocab
   32000, bf16), B=8, a 3584-token prompt, 512 new tokens. Checks 38
   ssd_scan and 6 flash launches in the prefill and 6 x 511 decode
   launches, tokens in range, finite logits, and decode step 255 against a
   fresh prefill of its 3840 tokens: logits (scale-normalised error <= 5e-2,
   argmax agreeing on 7 of 8 rows) and all 38 SSM and conv states, and
   reads the states one token stale as a planted fault, which the bound
   must catch; then profiles the prefill (ssd_scan's share of device time)
   and 16 decode steps (the device's idle share);
8. data-service main path: ``repro_torch.launch.data_service --serve`` in
   a subprocess (1024 records of mean length 2048, vocab 32000,
   ``--co-refill``), the training path of phase 4 through it
   (``--data-server SOCK --device-path stage``) and a co-tenant job
   consuming epoch 0 over its own ``RedoxClient`` in a thread of this
   script. Checks 6 finite losses, the first near ln(vocab), both jobs'
   streams byte for byte against in-process loaders of their specs on the
   server's store, no gather launch (ring frames ship assembled grids),
   and reads the server's storage bytes against the two jobs' demand;
   profiles 4 steps of the same path for its idle share. Then
   ``--autotune --device-path gather --steps 3`` on a store the trainer
   builds: the calibrated choice, one gather launch a staged batch, and
   the staged batches against a loader on the reopened store. The server
   is stopped in a ``finally``; its stderr is shown if it dies or a check
   fails.

The last seven lines are the training path's numbers as JSON, the serving
path's, the hybrid serving path's, the data-service path's, the card's
name and power limit, the kernel table as JSON (five kernels), and
``{"ok": true, "device": {...}}``. Exits non-zero without a card, and in
a directory without the port's sources.

    python3 chip_smoke.py --gathers

runs phases 1-2 for ``chunk_gather`` only, the gathers' timings and
phase 4b's profile (the staged batch's device operations on the stager's
side stream), and prints them as JSON last.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
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

#: H100 SXM device memory rate and dense bf16 tensor-core rate (NVIDIA
#: data sheet), bytes/s and FLOP/s.
HBM_BYTES_PER_S = 3.35e12
#: Input sets the large gather rotates through in one graph (see time_gathers).
LARGE_GATHER_SETS = 8
BF16_FLOP_PER_S = 989e12
#: f32 outside the tensor cores (NVIDIA data sheet, 700 W).
F32_FLOP_PER_S = 67e12
KERNEL_PACKAGES = ("chunk_gather", "flash_attention", "decode_attention", "ssd_scan")
MAIN_ARGS = ["--arch", "tinyllama-1.1b", "--full", "--nodes", "2", "--batch", "8",
             "--seq-len", "2048", "--device-path", "gather", "--remat", "dots",
             "--steps", "6"]
SERVE_ARGS = ["--arch", "tinyllama-1.1b", "--full", "--batch", "8", "--prompt-len", "1920",
              "--new-tokens", "128", "--seed", "0"]
SMALL_TOL = 1e-4  # f32 on the card vs the CPU: summation order only
#: int8 caches on the card vs the CPU: K/V that agree to f32 summation
#: order can still round to neighbouring codes at a .5 boundary, and one
#: such code moved reduced-model logits by 2.8e-4 of their max
#: (tests/test_torch_serve.py); the greedy tokens must still be equal.
SMALL_INT8_TOL = 1e-3
#: Decode against a fresh prefill at full width in bf16: the two paths
#: round at different places (GEMMs of other shapes, the kernels' p cast).
#: Reduced widths at the full depth reached 8.2e-3 on the CPU
#: (tests/test_torch_serve.py::test_decode_matches_fresh_prefill); a wrong
#: cache slot or mask gives errors of order 1.
AGREEMENT_TOL = 5e-2
AGREEMENT_MIN_ROWS = 7
AGREEMENT_STEPS = (0, 42, 84, 126)
HYBRID_ARGS = ["--arch", "zamba2-1.2b", "--full", "--batch", "8", "--prompt-len", "3584",
               "--new-tokens", "512", "--seed", "0"]
#: The decode step held to a fresh prefill: after it the cache holds 3840
#: tokens, a multiple of the 256-token SSD chunk, which a prefill needs.
HYBRID_AGREEMENT_STEP = 255
#: Decode's SSM and conv states after that step against the fresh
#: prefill's, per leaf the worst per-layer scale-normalised error. Reduced
#: widths at Zamba2's depth, SSM head dim and state in bf16 reached 2.6e-2
#: (ssm) and 8.9e-3 (conv) on the CPU over 35 tokens (tests/
#: test_torch_serve.py::test_hybrid_decode_matches_fresh_prefill); this
#: phase on an H100 at 3840 tokens read 4.5e-2 and 3.0e-2. The phase also
#: reads a planted fault, decode's states one token stale (after step 254)
#: against the same prefill, and fails unless that reading lies above the
#: bound: the bound must tell a state that missed one token from a sound one.
HYBRID_STATE_TOL = {"ssm": 1e-1, "conv": 5e-2}
#: Phase 8: the data server's store (1024 records of mean length 2048 at
#: tinyllama's vocab) and the trainer through it at phase 4's width.
DATA_SERVICE_ARGS = ["--num-docs", "1024", "--seq-len", "2048", "--vocab-size", "32000",
                     "--co-refill"]
SERVED_ARGS = ["--arch", "tinyllama-1.1b", "--full", "--job-id", "job0", "--device-path",
               "stage", "--batch", "8", "--seq-len", "2048", "--nodes", "2", "--remat",
               "dots", "--steps", "6"]
#: The co-tenant job's session: the trainer's shape, seeds of its own
#: (the trainer's are 2 and 3 at ``--seed 0``).
CO_TENANT_SPEC = {"seed": 12, "sampler_seed": 13, "num_nodes": 2, "batch_per_node": 4,
                  "seq_len": 2048, "remote_memory_limit_bytes": 1_000_000}
AUTOTUNE_ARGS = ["--arch", "tinyllama-1.1b", "--full", "--nodes", "2", "--batch", "8",
                 "--seq-len", "2048", "--device-path", "gather", "--remat", "dots",
                 "--autotune", "--steps", "3"]


class PhaseClock:
    """Prints each phase's heading and, at the next heading, its wall time."""

    def __init__(self):
        self.times: dict = {}
        self._name, self._t0 = None, time.perf_counter()

    def __call__(self, name: str | None) -> None:
        now = time.perf_counter()
        if self._name is not None:
            self.times[self._name] = now - self._t0
            print(f"-- {self._name}: {now - self._t0:.1f} s wall", flush=True)
        self._name, self._t0 = name, now
        if name is not None:
            print(f"\n== {name}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


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
    del graph
    torch.cuda.empty_cache()
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


def turns(kernel, plain, library=None, **kw) -> dict:
    """Device time per call in turns (plain, kernel, kernel, plain, and the
    library call last), so drift hits both versions alike."""
    p1 = graph_ms(plain, **kw)
    k1, k2 = graph_ms(kernel, **kw), graph_ms(kernel, **kw)
    p2 = graph_ms(plain, **kw)
    out = {"ms": statistics.median([k1, k2]), "plain_ms": statistics.median([p1, p2]),
           "runs_ms": [k1, k2], "plain_runs_ms": [p1, p2], "library_ms": None}
    if library is not None:
        out["library_ms"] = graph_ms(library, **kw)
    return out


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


def bound(flops: float, moved: int, rate: float = BF16_FLOP_PER_S) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the
    operations over their peak rate (bf16 tensor cores unless given) and
    the bytes over the memory rate, and which of the two it is."""
    t_ops, t_bytes = flops / rate * 1e3, moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def _wrappers() -> dict:
    from repro_torch.kernels.chunk_gather.ops import chunk_gather, chunk_gather_train
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    return {"chunk_gather_train": chunk_gather_train, "chunk_gather": chunk_gather,
            "flash_attention": flash_attention, "decode_attention": decode_attention,
            "ssd_scan": ssd_scan}


def zero_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


# --------------------------------------------------------------- phase 3
def launch_floor() -> float:
    """The least time one launch takes in :func:`graph_ms`: a one-element
    ``fill_`` on the card, in ms."""
    import torch

    x = torch.empty(1, device="cuda")
    return graph_ms(lambda: x.fill_(1.0))


def large_gather_sets(device, sets: int = LARGE_GATHER_SETS) -> tuple[int, list]:
    """``sets`` input sets of the large shape: the repo's ``train_4k``
    (S = 4096, global batch 256) staged as one batch, B = U = 256, slot rows
    padded to 8 as the stager packs them; ``idx`` a permutation (every
    record distinct, as exactly-once makes them), ``lens`` uniform in
    [1, S + 1], from numpy with seed 0."""
    import numpy as np
    import torch

    from repro_torch.configs.shapes import get_shape

    shape = get_shape("train_4k")
    b, s = shape.global_batch, shape.seq_len
    lp = -(-(s + 1) // 8) * 8
    rng = np.random.default_rng(0)
    out = []
    for _ in range(sets):
        lens = rng.integers(1, s + 2, b)
        slots = rng.integers(1, 32000, (b, lp))
        idx = rng.permutation(b)
        out.append(tuple(torch.as_tensor(np.asarray(a, np.int32), device=device)
                         for a in (slots, lens, idx)))
    return s, out


def time_gathers(device) -> dict:
    """Both gathers timed at B = 8 beside the launch floor (before and
    after), with their plain versions and host time per call; then
    ``chunk_gather_train`` at the large shape, each input set first held to
    its plain version (tolerance 0), timed with the L2 defeated: each
    captured call takes the next of 8 input sets and keeps its outputs, so
    between two reads of one set some 100 MB pass through the 50 MB L2."""
    import itertools

    import torch

    from repro_torch.kernels import parity
    from repro_torch.kernels.chunk_gather.ops import chunk_gather, chunk_gather_train
    from repro_torch.kernels.chunk_gather.ref import chunk_gather_ref, chunk_gather_train_ref

    floor = [launch_floor()]
    train_case = parity.KernelCase("chunk_gather_train", (8, 2048, 8), "int32")
    slot, lens, idx = parity.make_inputs(train_case, device=device, row_pad=8)

    def train():
        return chunk_gather_train(slot, lens, idx, seq_len=2048)

    def train_plain():
        return chunk_gather_train_ref(slot, lens, idx, seq_len=2048)

    raw_case = parity.KernelCase("chunk_gather", (8, 2176, 8), "int32")
    rslots, rlens, ridx = parity.make_inputs(raw_case, device=device)

    def raw():
        return chunk_gather(rslots, rlens, ridx)

    def raw_plain():
        return chunk_gather_ref(rslots, rlens, ridx)

    out = {"chunk_gather_train": turns(train, train_plain),
           "chunk_gather": turns(raw, raw_plain)}
    for name, (kernel, plain) in (("chunk_gather_train", (train, train_plain)),
                                  ("chunk_gather", (raw, raw_plain))):
        out[name].update(host_ms=host_ms(kernel), plain_host_ms=host_ms(plain))
    floor.append(launch_floor())
    out["floor_runs_ms"] = floor
    out["floor_ms"] = statistics.median(floor)
    # The stores alone: one fill_ of the trainer's three outputs.
    grids = torch.empty((3, 8, 2048), dtype=torch.int32, device=device)
    out["store_floor_ms"] = graph_ms(lambda: grids.fill_(0))
    moved, rows = gather_bytes(slot, lens, idx, 2048)
    out["chunk_gather_train"].update(bytes=moved, rows=rows, inputs=(slot, lens, idx),
                                     shape=f"B=8 S=2048 Lp={slot.shape[1]}")
    rows = torch.unique(ridx.long())
    row_len = rslots.shape[1]
    # idx read once; lens and the first min(len, L) tokens of each distinct
    # selected row read once; (B, L) int32 tokens and f32 mask written once.
    moved = (ridx.numel() * 4 + rows.numel() * 4
             + int(rlens[rows].long().clamp(max=row_len).sum()) * 4 + ridx.numel() * row_len * 8)
    out["chunk_gather"].update(bytes=moved, rows=rows.numel(), inputs=(rslots, rlens, ridx),
                               shape=f"B=8 L={row_len}")

    s, sets = large_gather_sets(device)
    for i, inputs in enumerate(sets):
        got = chunk_gather_train(*inputs, seq_len=s)
        want = chunk_gather_train_ref(*inputs, seq_len=s)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"chunk_gather_train at the large shape, input set {i}: kernel disagrees "
                 f"with its plain version (tolerance 0)")
    del got, want
    cycle, keep = itertools.cycle(sets), []

    def large():
        slots_, lens_, idx_ = next(cycle)
        keep.append(chunk_gather_train(slots_, lens_, idx_, seq_len=s))

    runs = []
    for _ in range(2):
        runs.append(graph_ms(large))
        keep.clear()
    moved = statistics.mean(gather_bytes(*inputs, s)[0] for inputs in sets)
    bound_ms, _ = bound(0, moved)
    out["large"] = {"shape": f"B=U={sets[0][2].numel()} S={s} Lp={sets[0][0].shape[1]}",
                    "runs_ms": runs, "bytes": moved, "bound_ms": bound_ms,
                    "share_of_bound": [bound_ms / r for r in runs], "sets": len(sets)}
    return out


def print_gather_times(t: dict) -> None:
    floor = t["floor_runs_ms"]
    print(f"launch floor (a one-element fill_, CUDA graph of 50 calls): "
          f"{floor[0] * 1e3:.3f} / {floor[1] * 1e3:.3f} us (before / after the gathers); "
          f"a fill_ of the trainer's three (8, 2048) outputs: "
          f"{t['store_floor_ms'] * 1e3:.3f} us")
    for name in ("chunk_gather_train", "chunk_gather"):
        g = t[name]
        print(f"{name} at {g['shape']}: device time per call (CUDA graph of 50 calls, CUDA "
              f"events): kernel {g['runs_ms'][0] * 1e3:.3f} / {g['runs_ms'][1] * 1e3:.3f} us "
              f"(floor {t['floor_ms'] * 1e3:.3f} us), plain {g['plain_runs_ms'][0] * 1e3:.3f} / "
              f"{g['plain_runs_ms'][1] * 1e3:.3f} us; host time per call: kernel "
              f"{g['host_ms'] * 1e3:.2f} us, plain {g['plain_host_ms'] * 1e3:.2f} us; bound "
              f"{g['bytes'] / HBM_BYTES_PER_S * 1e6:.4f} us ({g['bytes']} bytes, {g['rows']} "
              f"distinct slot rows, at 3.35 TB/s); library: none")
    big = t["large"]
    print(f"chunk_gather_train at {big['shape']} ({big['sets']} input sets rotated, outputs "
          f"kept, each equal to its plain version): {big['runs_ms'][0] * 1e3:.3f} / {big['runs_ms'][1] * 1e3:.3f} us against a "
          f"{big['bound_ms'] * 1e3:.3f} us bound ({big['bytes']:.0f} bytes at 3.35 TB/s): "
          f"{big['share_of_bound'][0]:.1%} / {big['share_of_bound'][1]:.1%} of it")


def check_gather_edges(device) -> None:
    """Both gathers over their edge grid (``chunk_gather/edges.py``: both
    paths, views at offsets 0-3, row lengths at run, warp and block edges,
    n at 0, 1, 3, 4, 5, S, S + 1, out-of-range slots), exactly, then a
    replay check of each on each path."""
    import torch

    from repro_torch.kernels.chunk_gather import edges

    cases = edges.edge_cases(device)
    for case in cases:
        got, want = edges.run(case), edges.expected(case)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"gather edge case {case.name}: kernel disagrees with its plain version "
                 f"(tolerance 0)")
    paths = {c.vector for c in cases}
    if paths != {True, False}:
        fail(f"the gather edge grid took only the {'vector' if True in paths else 'scalar'} path")
    print(f"gather edge grid: {len(cases)} cases ({sum(c.vector for c in cases)} on the 16-byte "
          f"path, {sum(not c.vector for c in cases)} scalar) equal their plain versions")
    for case in cases:
        if case.inputs[0].shape[1] in (2056, 2176) and case.offset in (0, 1):
            check_replay(f"{case.name} ({'16-byte' if case.vector else 'scalar'} path)",
                         lambda c=case: torch.cat([t.view(torch.int32).flatten()
                                                   for t in edges.run(c)]))


def check_chunk_gather(device) -> None:
    """chunk_gather_train against its plain version (exact) over the parity
    grid and the trainer's shape (row_pad 8, as the stager packs), then
    both gathers' edge grid."""
    import torch

    from repro_torch.kernels import parity

    trainer_case = parity.KernelCase("chunk_gather_train", (8, 2048, 8), "int32")
    cases = [(c, 128) for c in parity.iter_cases("chunk_gather_train")] + [(trainer_case, 8)]
    for case, row_pad in cases:
        inputs = parity.make_inputs(case, device=device, row_pad=row_pad)
        got = parity.run_kernel(case, inputs)
        want = parity.run_ref(case, inputs)
        torch.cuda.synchronize()
        abs_err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"{case.name}: kernel disagrees with its plain version "
                 f"(max abs err {abs_err}, tolerance 0)")
        print(f"{case.name} row_pad {row_pad}: equal (max abs err {abs_err})")
    check_gather_edges(device)


def gather_row(name: str, times: dict) -> dict:
    """A gather's kernel-table row: its B = 8 timing from ``times``, its
    result there held to its plain version."""
    from repro_torch.kernels import parity
    from repro_torch.kernels.chunk_gather import ops, ref

    t = times[name]
    inputs = t["inputs"]
    kw = {"seq_len": 2048} if name == "chunk_gather_train" else {}
    got = getattr(ops, name)(*inputs, **kw)
    want = getattr(ref, f"{name}_ref")(*inputs, **kw)
    abs_err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    if abs_err != 0:
        fail(f"{name} at {t['shape']}: max abs err {abs_err}, tolerance 0")
    bound_ms, bound_by = bound(0, t["bytes"])
    spec = parity.KERNELS[name]
    row = {"name": name, "route": "cuda", "source": spec["source"],
           "replaces": spec["replaces"], "launches": None, "max_abs_err": abs_err,
           "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None, "runs_ms": t["runs_ms"],
           "floor_ms": times["floor_ms"], "host_ms": t["host_ms"],
           "plain_host_ms": t["plain_host_ms"], "bytes": t["bytes"]}
    if name == "chunk_gather_train":
        row["at_large_shape"] = times["large"]
    return row


def check_attention_grid(device) -> None:
    """Both attention kernels against their plain versions over the parity
    grid and edge cases: fully masked decode rows, lengths that are not a
    multiple of the tiles, windows whose first kv tile is fully masked,
    then :func:`check_flash_edges` and :func:`check_decode_edges`."""
    import torch

    from repro_torch.kernels import parity
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    extra = [parity.KernelCase("decode_attention", shape, dtype)
             for shape in ((2, 8, 2, 40, 64), (2, 4, 4, 96, 32), (3, 32, 4, 72, 64))
             for dtype in ("float32", "bfloat16")]
    for case in parity.iter_cases("flash_attention") + parity.iter_cases("decode_attention") \
            + extra:
        inputs = parity.make_inputs(case, device=device)
        if case.kernel == "decode_attention":
            inputs[3][0] = False  # batch row 0: no valid slot
        got = parity.run_kernel(case, inputs)
        want = parity.run_ref(case, inputs)
        torch.cuda.synchronize()
        err = parity.max_err(got, want)
        tol = parity.KERNELS[case.kernel]["tols"][case.dtype]
        if not err <= tol or not torch.isfinite(got.float()).all():
            fail(f"{case.name}: kernel disagrees with its plain version "
                 f"(scale-normalised err {err:.3e}, tolerance {tol})")
        if case.kernel == "decode_attention" and got[0].any():
            fail(f"{case.name}: a fully masked row is not zeros")
        print(f"{case.name}: scale-normalised err {err:.3e} (tolerance {tol})")
    gen = torch.Generator(device=device).manual_seed(0)
    for dtype in ("float32", "bfloat16"):
        for s, causal, window in ((96, True, 16), (100, True, 0), (80, False, 24),
                                  (130, True, 1), (200, True, 70)):
            q, k, v = (torch.randn(2, s, 32, generator=gen, device=device)
                       .to(getattr(torch, dtype)) for _ in range(3))
            err = parity.max_err(flash_attention(q, k, v, causal=causal, window=window),
                                 attention_ref(q, k, v, causal=causal, window=window))
            tol = parity.KERNELS["flash_attention"]["tols"][dtype]
            if not err <= tol:
                fail(f"flash_attention S={s} causal={causal} window={window} {dtype}: "
                     f"err {err:.3e} > {tol}")
            print(f"flash_attention S={s} causal={causal} window={window} {dtype}: "
                  f"scale-normalised err {err:.3e} (tolerance {tol})")
    check_flash_edges(device)
    check_decode_edges(device)


#: Flash edge cases at the 128-row tiles' edges: (S, window, causal, (D, G)).
#: Windows of 127-129 leave some rows' first kv tile fully masked.
FLASH_EDGES = list(itertools.product((1, 127, 128, 129, 255, 257), (0, 127, 128, 129),
                                     (True, False), ((32, 1), (64, 4), (128, 8))))


def check_flash_edges(device) -> None:
    """flash_attention_gqa (B=2, 2 kv heads) against its plain version at
    the tile edges: every case of FLASH_EDGES in bf16, and those at D = 64
    with window 0 or 128 in f32; then :func:`check_replay` of a bf16 call
    (its work counters reset)."""
    import torch

    from repro_torch.kernels import parity
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
    from repro_torch.kernels.flash_attention.ref import attention_gqa_ref

    gen = torch.Generator(device=device).manual_seed(4)
    tols = parity.KERNELS["flash_attention"]["tols"]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(*c, "bfloat16") for c in FLASH_EDGES] + [
        (*c, "float32") for c in FLASH_EDGES if c[1] in (0, 128) and c[3][0] == 64]
    for s, window, causal, (d, g), dtype in cases:
        q = torch.randn(2, s, 2 * g, d, generator=gen, device=device).to(getattr(torch, dtype))
        k, v = (torch.randn(2, s, 2, d, generator=gen, device=device).to(q.dtype)
                for _ in range(2))
        got = flash_attention_gqa(q, k, v, causal=causal, window=window)
        err = parity.max_err(got, attention_gqa_ref(q, k, v, causal=causal, window=window))
        if not err <= tols[dtype] or not torch.isfinite(got.float()).all():
            fail(f"flash_attention_gqa S={s} window={window} causal={causal} D={d} G={g} "
                 f"{dtype}: scale-normalised err {err:.3e} > {tols[dtype]}")
        worst[dtype] = max(worst[dtype], err)
    q = torch.randn(2, 1000, 8, 64, generator=gen, device=device).bfloat16()
    k, v = (torch.randn(2, 1000, 2, 64, generator=gen, device=device).bfloat16()
            for _ in range(2))
    check_replay("flash_attention_gqa (persistent blocks, work counters)",
                 lambda: flash_attention_gqa(q, k, v, causal=True, window=300))
    print(f"flash_attention_gqa at the tile edges: {len(cases)} cases (S 1-257, windows "
          f"0/127/128/129, causal and not, D 32/64/128, G 1/4/8); worst scale-normalised "
          f"err f32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e} (tolerance "
          f"{tols['float32']} / {tols['bfloat16']})")


def ring_mask(b: int, s: int, start: int, count: int, device):
    """(B, S) validity of ``count`` ring slots from ``start``, wrapping
    past S; batch row 0 fully masked."""
    import torch

    slots = (torch.arange(s, device=device) - start) % s
    mask = (slots < count)[None, :].expand(b, s).contiguous()
    mask[0] = False
    return mask


def check_decode_edges(device) -> None:
    """decode_attention against its plain version at G = 1, 2, 4, 8, 16: a
    shape whose cache is split (few blocks, 1000 slots) and one that is
    not (256 blocks), S not a multiple of any tile, a ring mask that wraps,
    batch row 0 fully masked; then :func:`check_decode_replay`."""
    import torch

    from repro_torch.kernels import parity
    from repro_torch.kernels.decode_attention.ops import (
        _sm_count, _splits, decode_attention, query_group)
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain

    gen = torch.Generator(device=device).manual_seed(5)
    tols = parity.KERNELS["decode_attention"]["tols"]
    for i, g in enumerate((1, 2, 4, 8, 16)):
        d = (32, 64, 128)[i % 3]
        for b, kvh, s in ((2, 2, 1000), (16, 16, 300)):  # split, and not
            blocks = b * kvh * -(-g // query_group(g))
            splits = _splits(blocks, s, _sm_count(device.index or 0))
            for dtype in ("float32", "bfloat16"):
                q = torch.randn(b, kvh * g, d, generator=gen, device=device).to(
                    getattr(torch, dtype))
                ck, cv = (torch.randn(b, s, kvh, d, generator=gen, device=device).to(q.dtype)
                          for _ in range(2))
                mask = ring_mask(b, s, s - 37, s - 5, device)
                got = decode_attention(q, ck, cv, mask)
                err = parity.max_err(got, decode_attention_plain(q, ck, cv, mask))
                if not err <= tols[dtype] or not torch.isfinite(got.float()).all() \
                        or got[0].any():
                    fail(f"decode_attention G={g} {(b, kvh, s, d)} {dtype}, {splits} splits: "
                         f"scale-normalised err {err:.3e} (tolerance {tols[dtype]}) or row 0 "
                         f"not zeros")
                print(f"decode_attention G={g} (B, KVH, S, D)={(b, kvh, s, d)} {dtype}, "
                      f"{splits} splits: scale-normalised err {err:.3e} (tolerance "
                      f"{tols[dtype]}); fully masked row zeros")
    check_decode_replay(device)


def check_replay(name: str, fn) -> None:
    """``fn()`` run twice in a row, then captured in a CUDA graph replayed
    three times: every result must equal the first bit for bit (a kernel's
    self-resetting counters are back at 0 after each launch)."""
    import torch

    first = fn()
    runs = [fn()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(3):
        graph.replay()
        runs.append(out.clone())
    torch.cuda.synchronize()
    if not all(torch.equal(r, first) for r in runs):
        fail(f"{name} differs between calls or graph replays (counters not reset?)")
    print(f"{name}: a second call and 3 graph replays equal the first call bit for bit")
    del graph


def check_decode_replay(device) -> None:
    """:func:`check_replay` of decode_attention at a shape whose splits
    merge through the ticket counters."""
    from repro_torch.kernels import parity
    from repro_torch.kernels.decode_attention.ops import _sm_count, _splits, decode_attention

    case = parity.KernelCase("decode_attention", (8, 32, 4, 2048, 64), "bfloat16")
    q, ck, cv, _ = parity.make_inputs(case, device=device)
    mask = ring_mask(8, 2048, 100, 2000, device)
    splits = _splits(8 * 4, 2048, _sm_count(device.index or 0))
    if splits < 2:
        fail(f"the replay check needs a split shape, got {splits} split")
    check_replay(f"decode_attention with {splits} splits",
                 lambda: decode_attention(q, ck, cv, mask))


def check_flash_main(device) -> dict:
    """flash_attention at the prefill's shapes: parity as a (BH, S, D) call,
    timing as the GQA call the model makes, at tinyllama's prefill (the
    row's numbers) and at zamba2's (``at_hybrid_shape``)."""
    from repro_torch.kernels import parity

    case = parity.KernelCase("flash_attention", (256, 1920, 64, True), "bfloat16")
    inputs = parity.make_inputs(case, device=device)
    err = parity.max_err(parity.run_kernel(case, inputs), parity.run_ref(case, inputs))
    tol = parity.KERNELS["flash_attention"]["tols"]["bfloat16"]
    if not err <= tol:
        fail(f"{case.name}: err {err:.3e} > {tol}")
    print(f"{case.name}: scale-normalised err {err:.3e} (tolerance {tol})")
    del inputs
    row = flash_timing(device, 8, 1920, 32, 4, calls=5)
    hybrid = flash_timing(device, 8, 3584, 32, 32, calls=1)
    spec = parity.KERNELS["flash_attention"]
    return {"name": "flash_attention", "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": None, **row, "at_hybrid_shape": hybrid}


def flash_timing(device, b: int, s: int, h: int, kvh: int, *, d: int = 64, calls: int) -> dict:
    """flash_attention_gqa on causal (B, S, H, D) x (B, S, KVH, D) bf16:
    parity with its plain version, and kernel / plain / library time."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import parity
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
    from repro_torch.kernels.flash_attention.ref import attention_gqa_ref

    tol = parity.KERNELS["flash_attention"]["tols"]["bfloat16"]
    gen = torch.Generator(device=device).manual_seed(1)
    q = torch.randn(b, s, h, d, generator=gen, device=device).bfloat16()
    k, v = (torch.randn(b, s, kvh, d, generator=gen, device=device).bfloat16()
            for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    got, want = flash_attention_gqa(q, k, v), attention_gqa_ref(q, k, v)
    err = parity.max_err(got, want)
    abs_err = float((got.float() - want.float()).abs().max())
    if not err <= tol:
        fail(f"flash_attention_gqa at {(b, s, h, kvh, d)}: err {err:.3e} > {tol}")
    del got, want
    torch.cuda.empty_cache()
    t = turns(lambda: flash_attention_gqa(q, k, v, causal=True),
              lambda: attention_gqa_ref(q, k, v, causal=True),
              lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                     enable_gqa=True),
              calls=calls, reps=5)
    flops = 4 * d * (s * (s + 1) // 2) * b * h  # unmasked causal pairs, QK^T and PV
    moved = 2 * (q.numel() * 2 + k.numel() + v.numel())  # q, k, v read; out written
    bound_ms, bound_by = bound(flops, moved)
    print(f"flash_attention_gqa q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal: device "
          f"time per call (CUDA graph of {calls} calls): kernel {t['runs_ms'][0]:.4f} / "
          f"{t['runs_ms'][1]:.4f} ms, plain {t['plain_runs_ms'][0]:.4f} / "
          f"{t['plain_runs_ms'][1]:.4f} ms, library (scaled_dot_product_attention) "
          f"{t['library_ms']:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: {flops:.4g} FLOP "
          f"at 989 TFLOP/s, {moved} bytes at 3.35 TB/s); scale-normalised err {err:.3e}, "
          f"max abs err {abs_err:.4g}")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return {"max_abs_err": abs_err, "max_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": t["library_ms"],
            "flops": flops, "bytes": moved}


def check_decode_main(device) -> dict:
    """decode_attention at the decode's shapes with the real ring mask of
    the last decode step: tinyllama's (cache position 2046 of 2048 slots;
    the row's numbers) and zamba2's (4094 of 4096, G = 1;
    ``at_hybrid_shape``)."""
    from repro_torch.kernels import parity

    row = decode_timing(device, 8, 32, 4, 2048)
    hybrid = decode_timing(device, 8, 32, 32, 4096)
    spec = parity.KERNELS["decode_attention"]
    return {"name": "decode_attention", "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": None, **row, "at_hybrid_shape": hybrid}


def decode_timing(device, b: int, h: int, kvh: int, s: int, *, d: int = 64) -> dict:
    """decode_attention on a (B, S, KVH, D) bf16 cache at position S - 2:
    parity with its plain version, and kernel / plain / library time."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import parity
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain
    from repro_torch.models.attention import slot_validity

    case = parity.KernelCase("decode_attention", (b, h, kvh, s, d), "bfloat16")
    q, ck, cv, _ = parity.make_inputs(case, device=device)
    mask = slot_validity(s - 2, s, 0, device)[None, :].expand(b, s).contiguous()
    got, want = decode_attention(q, ck, cv, mask), decode_attention_plain(q, ck, cv, mask)
    err = parity.max_err(got, want)
    abs_err = float((got.float() - want.float()).abs().max())
    tol = parity.KERNELS["decode_attention"]["tols"]["bfloat16"]
    if not err <= tol:
        fail(f"decode_attention at {(b, h, kvh, s, d)}: err {err:.3e} > {tol}")
    qt = q[:, :, None, :]
    kt, vt = (x.transpose(1, 2).contiguous() for x in (ck, cv))
    amask = mask[:, None, None, :]
    t = turns(lambda: decode_attention(q, ck, cv, mask),
              lambda: decode_attention_plain(q, ck, cv, mask),
              lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask,
                                                     enable_gqa=True))
    valid = int(mask.sum())  # (batch, slot) pairs whose K and V must be read
    moved = 2 * q.numel() * 2 + mask.numel() + 2 * valid * kvh * d * 2
    flops = 4 * d * valid * h
    bound_ms, bound_by = bound(flops, moved)
    print(f"decode_attention q {tuple(q.shape)} cache {tuple(ck.shape)} bf16, "
          f"{valid // b} valid slots: device time per call (CUDA graph of 50 calls): kernel "
          f"{t['runs_ms'][0] * 1e3:.2f} / {t['runs_ms'][1] * 1e3:.2f} us, plain "
          f"{t['plain_runs_ms'][0] * 1e3:.2f} / {t['plain_runs_ms'][1] * 1e3:.2f} us, "
          f"library (scaled_dot_product_attention) {t['library_ms'] * 1e3:.2f} us; bound "
          f"{bound_ms * 1e3:.3f} us ({bound_by}: {moved} bytes at 3.35 TB/s); "
          f"scale-normalised err {err:.3e}, max abs err {abs_err:.4g}")
    return {"max_abs_err": abs_err, "max_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": t["library_ms"],
            "bytes": moved}


def check_chunk_gather_raw(device) -> None:
    """The raw chunk_gather against its plain version (exact) over its
    grid and a training-sized shape (B = 8 rows of L = 2176, a slot row of
    the trainer's S = 2048 padded to 128)."""
    import torch

    from repro_torch.kernels import parity

    main_case = parity.KernelCase("chunk_gather", (8, 2176, 8), "int32")
    for case in parity.iter_cases("chunk_gather") + [main_case]:
        inputs = parity.make_inputs(case, device=device)
        got, want = parity.run_kernel(case, inputs), parity.run_ref(case, inputs)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"{case.name}: kernel disagrees with its plain version (tolerance 0)")
        print(f"{case.name}: equal")


def check_ssd_grid(device) -> None:
    """ssd_scan against its plain version over the parity grid and edge
    cases: a chunk that does not divide the kernel's 64-step tile, a chunk
    of 1, S not a multiple of the tile, a state that decays below 1e-30
    within a step, the model-layout entry with an initial state, the
    head-group edges (:func:`check_ssd_heads_edges`) and a replay check."""
    import torch

    from repro_torch.kernels import parity
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_heads
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_heads_ref, ssd_scan_ref

    tols = parity.KERNELS["ssd_scan"]["tols"]
    extra = [parity.KernelCase("ssd_scan", shape, dtype)
             for shape in ((3, 100, 64, 64, 24), (2, 70, 32, 16, 1), (2, 200, 48, 40, 200))
             for dtype in ("float32", "bfloat16")]
    for case in parity.iter_cases("ssd_scan") + extra:
        inputs = parity.make_inputs(case, device=device)
        got = parity.run_kernel(case, inputs)
        want = parity.run_ref(case, inputs)
        torch.cuda.synchronize()
        err = parity.max_err(got, want)
        if not err <= tols[case.dtype] or not torch.isfinite(got.float()).all():
            fail(f"{case.name}: kernel disagrees with its plain version "
                 f"(scale-normalised err {err:.3e}, tolerance {tols[case.dtype]})")
        print(f"{case.name}: scale-normalised err {err:.3e} (tolerance {tols[case.dtype]})")
    gen = torch.Generator(device=device).manual_seed(2)
    x, b, c = (torch.randn(2, 150, n, generator=gen, device=device) for n in (32, 16, 16))
    dt = torch.full((2, 150), 5.0, device=device)
    a = torch.full((2, 1), -20.0, device=device)  # exp(a dt) = 3.7e-44 per step
    got = ssd_scan(x, dt, a, b, c, chunk=64)
    err = parity.max_err(got, ssd_scan_ref(x, dt, a, b, c))
    if not err <= tols["float32"] or not torch.isfinite(got).all():
        fail(f"ssd_scan with a state decaying below 1e-30: err {err:.3e}")
    print(f"ssd_scan, state decaying by 3.7e-44 a step: scale-normalised err {err:.3e}")
    # The same in bf16 through the model layout (f32 out): denormal lo terms.
    args = (x.bfloat16()[:, :, None], dt[:, :, None], a[0], b.bfloat16(), c.bfloat16())
    got = ssd_scan_heads(*args)
    err = parity.max_err(got, ssd_scan_heads_ref(*args))
    if not err <= tols["float32"] or not all(torch.isfinite(t).all() for t in got):
        fail(f"ssd_scan_heads bf16 with a state decaying below 1e-30: err {err:.3e}")
    print(f"ssd_scan_heads bf16, state decaying by 3.7e-44 a step: scale-normalised err "
          f"{err:.3e} (tolerance {tols['float32']})")
    xh = torch.randn(2, 90, 3, 64, generator=gen, device=device)
    dth = torch.rand(2, 90, 3, generator=gen, device=device) * 0.5 + 0.01
    ah = -torch.rand(3, generator=gen, device=device) * 2 - 0.1
    bh, ch = (torch.randn(2, 90, 64, generator=gen, device=device) for _ in range(2))
    s0 = torch.randn(2, 3, 64, 64, generator=gen, device=device)
    got = ssd_scan_heads(xh, dth, ah, bh, ch, s0)
    err = parity.max_err(got, ssd_scan_heads_ref(xh, dth, ah, bh, ch, s0))
    if not err <= tols["float32"] or not all(torch.isfinite(t).all() for t in got):
        fail(f"ssd_scan_heads with an initial state: err {err:.3e}")
    print(f"ssd_scan_heads with an initial state (y and final state): "
          f"scale-normalised err {err:.3e} (tolerance {tols['float32']})")
    check_ssd_heads_edges(device)
    args = ssd_heads_inputs(device, 2, 257, 65, 64, 64, init=True, strided=True,
                            dtype=torch.bfloat16, seed=5)
    check_replay("ssd_scan_heads bf16 (2, 257, 65, 64) with 64 states",
                 lambda: torch.cat([t.flatten() for t in ssd_scan_heads(*args)]))


def ssd_heads_inputs(device, b: int, s: int, h: int, p: int, n: int, *, init: bool,
                     strided: bool, dtype, seed: int) -> tuple:
    """Model-layout inputs: x, B and C contiguous, or column slices of one
    conv output (b, s, h p + 2 n) as the model hands them over; dt from
    [0.01, 0.51), A from [-2.1, -0.1); with ``init`` an f32 initial state."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    if strided:
        xbc = torch.randn(b, s, h * p + 2 * n, generator=gen, device=device).to(dtype)
        xh = xbc[..., : h * p].reshape(b, s, h, p)
        bm, cm = xbc[..., h * p : h * p + n], xbc[..., h * p + n :]
    else:
        xh = torch.randn(b, s, h, p, generator=gen, device=device).to(dtype)
        bm, cm = (torch.randn(b, s, n, generator=gen, device=device).to(dtype)
                  for _ in range(2))
    dt = torch.rand(b, s, h, generator=gen, device=device) * 0.5 + 0.01
    a = -torch.rand(h, generator=gen, device=device) * 2 - 0.1
    s0 = torch.randn(b, h, p, n, generator=gen, device=device) if init else None
    return xh, dt, a, bm, cm, s0


def check_ssd_heads_edges(device) -> None:
    """ssd_scan_heads against its plain version where the bf16 kernel's
    head groups, tiles and copies have edges: H of 1, G - 1, G, G + 1 and
    65 (G heads a block; heads past H masked), S of 1, 63, 64, 65 and 257
    (tiles of 64), (P, N) of (20, 12), (48, 40), (64, 64) and (18, 10)
    (zero padding to 64; (18, 10) gives 4-byte copies), with and without an
    initial state, contiguous and strided; bf16 and f32 inputs alike, at
    the registry's f32 tolerance (bf16 inputs are exact in f32). A bf16
    view with an odd element offset must raise."""
    import torch

    from repro_torch.kernels import parity
    from repro_torch.kernels.ssd_scan.ops import copy_width, heads_per_block, ssd_scan_heads
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_heads_ref

    tol = parity.KERNELS["ssd_scan"]["tols"]["float32"]
    group = heads_per_block()
    heads = sorted({hh for hh in (1, group - 1, group, group + 1, 65) if hh >= 1})
    worst, widths, count = {}, {}, 0
    for seed, (hh, s, (p, n), init, strided, dtype) in enumerate(itertools.product(
            heads, (1, 63, 64, 65, 257), ((20, 12), (48, 40), (64, 64), (18, 10)),
            (False, True), (False, True), (torch.bfloat16, torch.float32))):
        args = ssd_heads_inputs(device, 2, s, hh, p, n, init=init, strided=strided,
                                dtype=dtype, seed=seed)
        got = ssd_scan_heads(*args)
        want = ssd_scan_heads_ref(*args)
        torch.cuda.synchronize()
        err = parity.max_err(got, want)
        if not err <= tol or not all(torch.isfinite(t).all() for t in got):
            fail(f"ssd_scan_heads {dtype} (2, {s}, {hh}, {p}) N {n} init {init} strided "
                 f"{strided}: scale-normalised err {err:.3e} (tolerance {tol})")
        worst[dtype] = max(worst.get(dtype, 0.0), err)
        if dtype == torch.bfloat16:
            width = copy_width(*args[0:1], *args[3:5])
            widths[width] = widths.get(width, 0) + 1
        count += 1
    if sorted(widths) != [4, 8, 16]:
        fail(f"the edge grid copied in pieces of {sorted(widths)} bytes, not 4, 8 and 16")
    print(f"ssd_scan_heads edges, G = {group}: {count} cases (H {heads}; S 1, 63, 64, 65, 257; "
          f"(P, N) (20, 12), (48, 40), (64, 64), (18, 10); with and without a state; "
          f"contiguous and strided): worst err bf16 {worst[torch.bfloat16]:.3e}, f32 "
          f"{worst[torch.float32]:.3e} (tolerance {tol}); bf16 copies of 16 / 8 / 4 bytes in "
          f"{widths[16]} / {widths[8]} / {widths[4]} cases")
    xh, dt, a, bm, cm, _ = ssd_heads_inputs(device, 1, 8, 2, 16, 16, init=False, strided=False,
                                            dtype=torch.bfloat16, seed=0)
    odd = torch.empty(xh.numel() + 1, dtype=xh.dtype, device=device)[1:].view(xh.shape)
    odd.copy_(xh)
    try:
        ssd_scan_heads(odd, dt, a, bm, cm)
    except ValueError as exc:
        print(f"ssd_scan_heads refuses a bf16 x at an odd element offset: {exc}")
    else:
        fail("ssd_scan_heads took a bf16 x at an odd element offset")


def ssd_least_work(b: int, s: int, h: int, p: int, n: int) -> int:
    """The least FLOP of the scan, the bare recurrence: per step and head a
    P x N outer product into the state and a P x N contraction out of it."""
    return 4 * b * h * s * p * n


def ssd_tile_work(b: int, s: int, h: int, p: int, n: int, tile: int = 64) -> int:
    """FLOP of the chunked form at a tile of ``tile`` steps: per tile of L
    steps, the causal half of the intra term, L(L+1)/2 (N + P)
    multiply-adds, the inter term and the state update, 2 L N P."""
    full, rest = divmod(s, tile)
    per_head = sum(ln * (ln + 1) // 2 * (n + p) + 2 * ln * n * p
                   for ln in [tile] * full + ([rest] if rest else []))
    return 2 * b * h * per_head


def ssd_mma_work(b: int, s: int, h: int, group: int) -> int:
    """FLOP the bf16 kernel issues on the tensor cores (m16n8k16, 4096 FLOP
    each; P and N padded to 64): per 64-step tile, 80 for C Bᵀ a block and
    672 a head (intra 160, inter 256, update 256, the hi + lo splits
    doubled)."""
    tiles, blocks = -(-s // 64), -(-h // group)
    return b * tiles * (blocks * 80 + h * 672) * 4096


def check_ssd_main(device) -> dict:
    """ssd_scan at the prefill's shape, as the model calls it: x, B and C
    bf16 column slices of one conv output, dt from a softplus, A =
    -linspace(1, 16) (the init); y and the final state held to the plain
    version (f32 arithmetic on bf16-exact inputs: the registry's f32 2e-4).
    The bound is the bytes (the bare recurrence's FLOP take 0.03 ms on the
    bf16 tensor cores); its f32 CUDA-core time is printed beside it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import parity
    from repro_torch.kernels.ssd_scan.ops import heads_per_block, ssd_scan_heads
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_heads_ref

    b, s, h, p, n = 8, 3584, 64, 64, 64
    gen = torch.Generator(device=device).manual_seed(3)
    xbc = F.silu(torch.randn(b, s, h * p + 2 * n, generator=gen, device=device)).bfloat16()
    xh = xbc[..., : h * p].reshape(b, s, h, p)
    bm, cm = xbc[..., h * p : h * p + n], xbc[..., h * p + n :]
    dt = F.softplus(torch.randn(b, s, h, generator=gen, device=device))
    a = -torch.linspace(1.0, 16.0, h, device=device)
    got, want = ssd_scan_heads(xh, dt, a, bm, cm), ssd_scan_heads_ref(xh, dt, a, bm, cm)
    errs = [parity.max_err(g, w) for g, w in zip(got, want)]
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    tol = parity.KERNELS["ssd_scan"]["tols"]["float32"]
    if not max(errs) <= tol or not all(torch.isfinite(g).all() for g in got):
        fail(f"ssd_scan at the prefill shape: y err {errs[0]:.3e}, final state err "
             f"{errs[1]:.3e} (tolerance {tol})")
    del got, want
    torch.cuda.empty_cache()
    t = turns(lambda: ssd_scan_heads(xh, dt, a, bm, cm),
              lambda: ssd_scan_heads_ref(xh, dt, a, bm, cm), calls=1, reps=3)
    group = heads_per_block()
    flops, tile_flops = ssd_least_work(b, s, h, p, n), ssd_tile_work(b, s, h, p, n)
    mma_flops = ssd_mma_work(b, s, h, group)
    # x, B, C read once (bf16); dt (f32) and A once; y (f32) and the final
    # state (f32) written once.
    moved = (xh.numel() + bm.numel() + cm.numel()) * 2 + dt.numel() * 4 + a.numel() * 4 \
        + xh.numel() * 4 + b * h * p * n * 4
    bound_ms, bound_by = bound(flops, moved)
    f32_bound_ms, _ = bound(flops, moved, F32_FLOP_PER_S)
    print(f"ssd_scan_heads xh {tuple(xh.shape)} bf16 (strided), B/C {tuple(bm.shape)}, "
          f"{group} heads a block: y err {errs[0]:.3e}, final state err {errs[1]:.3e} "
          f"(tolerance {tol}), max abs err {abs_err:.4g}; device time per call (CUDA graph of "
          f"1 call): kernel {t['runs_ms'][0]:.4f} / {t['runs_ms'][1]:.4f} ms, plain "
          f"{t['plain_runs_ms'][0]:.2f} / {t['plain_runs_ms'][1]:.2f} ms; library: none; "
          f"bound {bound_ms:.4f} ms ({bound_by}: {moved} bytes at 3.35 TB/s; the bare "
          f"recurrence's {flops:.4g} FLOP take {flops / BF16_FLOP_PER_S * 1e3:.4f} ms at "
          f"989 TFLOP/s bf16); on the CUDA cores in f32 they would take {f32_bound_ms:.4f} ms "
          f"at 67 TFLOP/s; the kernel issues {mma_flops:.4g} FLOP on the tensor cores (the "
          f"chunked form at 64-step tiles is {tile_flops:.4g})")
    spec = parity.KERNELS["ssd_scan"]
    return {"name": "ssd_scan", "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": None, "max_abs_err": abs_err,
            "max_err": max(errs), "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "f32_bound_ms": f32_bound_ms, "group": group, "flops": flops,
            "tile_flops": tile_flops, "mma_flops": mma_flops, "bytes": moved}


# --------------------------------------------------------------- phase 4
def main_path(argv, *, batch: int, seq_len: int, vocab: int) -> dict:
    """Drive ``repro_torch.launch.train`` with ``argv``; check it; return
    its numbers, with the kernels' launches in the run (counts zeroed just
    before)."""
    import torch

    from repro_torch.core import ChunkStore, RedoxLoader
    from repro_torch.launch.train import parse_args, train

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        args = parse_args(argv + ["--workdir", work])
        staged = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        summary = train(args, on_batch=lambda step, feed: staged.append(feed))
        launches = read_launches()
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
        gathers = launches["chunk_gather_train"]
        if gathers == 0 or gathers != stats.steps or gathers != stats.kernel_steps:
            fail(f"kernel launches {gathers} != staged batches {stats.steps}")
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
        "launches": gathers, "losses": losses,
        "tokens_per_s": summary["tokens_per_s"],
        "steady_tokens_per_s": summary["steady_tokens_per_s"],
        "max_memory_allocated_gib": peak / 2**30,
        "overlap_fraction": stats.overlap_fraction,
        "mb_to_device": stats.bytes_to_device / 1e6, "staged_batches": stats.steps,
    }


def device_profile(prof, start_marker: str, kernel: str, steps: int) -> dict:
    """From a profiler run: the device's idle share from ``start_marker``
    to the last device event (``steps`` steps), the device operations per
    step, the heaviest kernels, the launches of kernels whose name holds
    ``kernel`` (fails without any), and over the whole run the device
    operations and device time per launch on the streams that ran it."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        trace_file = Path(work) / "trace.json"
        prof.export_chrome_trace(str(trace_file))
        events = json.loads(trace_file.read_text())["traceEvents"]
    start = min((e["ts"] for e in events if e.get("name") == start_marker), default=None)
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"],
                     e.get("args", {}).get("stream"))
                    for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if start is None or not device:
        fail("the profiler trace has no step marker or no device events")
    end = max(d[1] for d in device)
    busy, cur_s, cur_e, by_name, ops = 0.0, None, None, {}, 0
    for s_, e_, name, _ in device:
        s_, e_ = max(s_, start), min(e_, end)
        if e_ <= s_:
            continue
        ops += 1
        by_name[name] = by_name.get(name, 0.0) + (e_ - s_)
        if cur_e is None or s_ > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += 0.0 if cur_e is None else cur_e - cur_s
    window = end - start
    idle = 1.0 - busy / window
    print(f"device window {window / 1e3:.2f} ms, busy {busy / 1e3:.2f} ms, "
          f"idle share {idle:.4f}; {ops} device operations, {ops / steps:.1f} per step")
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for name, t in top:
        print(f"  {t / total:6.1%}  {t / 1e3:9.3f} ms  {name[:110]}")
    ours = sum(t for n, t in by_name.items() if kernel in n)
    each = [e_ - s_ for s_, e_, name, _ in device if kernel in name]
    if not each:
        fail(f"the profiled path shows no {kernel} on the device")
    streams = {stream for _, _, name, stream in device if kernel in name}
    on_streams = [(e_ - s_, name) for s_, e_, name, stream in device if stream in streams]
    kinds = {}
    for _, name in on_streams:
        kinds[name[:60]] = kinds.get(name[:60], 0) + 1
    print(f"  {kernel}: {ours / 1e3:.4f} ms of device time in the window "
          f"({ours / total:.4%}); {len(each)} launches in the whole run, "
          f"{statistics.mean(each):.3f} us each; on its streams {sorted(streams)}: "
          f"{len(on_streams) / len(each):.2f} device operations and "
          f"{sum(d for d, _ in on_streams) / len(each):.3f} us of device time a launch "
          f"({kinds})")
    return {"idle_share": idle, "window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "ops_per_step": ops / steps, "kernel_share": ours / total, "kernel_launches": len(each),
            "kernel_us_each": statistics.mean(each),
            "stream_ops_per_launch": len(on_streams) / len(each),
            "stream_us_per_launch": sum(d for d, _ in on_streams) / len(each),
            "top": [[name[:80], t / total] for name, t in top[:5]]}


def profile_training(argv, marker: str) -> tuple[dict, int]:
    """Profile a 4-step run of the training path from its third step;
    ``marker`` names the device operation that finds the stager's side
    stream. Returns :func:`device_profile`'s numbers and the run's staged
    batches."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.launch.train import parse_args, train

    def mark(step, feed):
        with record_function(f"chip_smoke.step{step}"):
            pass

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        args = parse_args(argv + ["--workdir", work, "--steps", "4"])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            summary = train(args, on_batch=mark)  # ends in torch.cuda.synchronize()
    print("steps 3-4:")
    return device_profile(prof, "chip_smoke.step2", marker, 2), summary["device_stats"].steps


def where_time_goes(argv) -> dict:
    """Phase 4b: the training path's profile, its side stream found by the
    gather."""
    out, _ = profile_training(argv, "chunk_gather_train_kernel")
    return {"idle_share": out["idle_share"], "window_ms": out["window_ms"],
            "busy_ms": out["busy_ms"], "ops_per_step": out["ops_per_step"],
            "gather_launches": out["kernel_launches"],
            "gather_us_each": out["kernel_us_each"],
            "side_stream_ops_per_batch": out["stream_ops_per_launch"],
            "side_stream_us_per_batch": out["stream_us_per_launch"]}


# --------------------------------------------------------------- phase 5
def serve_path(argv) -> dict:
    """Drive ``repro_torch.launch.serve`` with ``argv``; check it; return
    its numbers and the run's summary (counts zeroed just before)."""
    import torch

    from repro_torch.launch.serve import build_parser, prefill_agreement, serve

    args = build_parser().parse_args(argv)
    steps = args.new_tokens - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    summary = serve(args, keep_logits=AGREEMENT_STEPS)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    cfg_layers, vocab = summary["model"].cfg.num_layers, summary["model"].cfg.vocab_size
    print(f"launches {launches}; prefill {summary['prefill_s']:.4f} s; decode "
          f"{summary['decode_s']:.4f} s for {steps} steps, {summary['decode_tok_s']:.1f} "
          f"tok/s (all steps), {summary['steady_decode_tok_s']:.1f} tok/s (steps 2-{steps}); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    if launches["flash_attention"] != cfg_layers:
        fail(f"flash_attention launched {launches['flash_attention']} times, "
             f"expected {cfg_layers} (one per layer of the prefill)")
    if launches["decode_attention"] != cfg_layers * steps:
        fail(f"decode_attention launched {launches['decode_attention']} times, "
             f"expected {cfg_layers * steps}")
    tokens = summary["tokens"]
    if tokens.shape != (args.batch, args.new_tokens) or not (
            (tokens >= 0) & (tokens < vocab)).all():
        fail(f"tokens {tuple(tokens.shape)} out of shape or range [0, {vocab})")
    kept = [summary["prefill_logits"], *summary["logits"].values()]
    if len(kept) != 1 + len(AGREEMENT_STEPS) or not all(
            bool(torch.isfinite(x).all()) for x in kept):
        fail("a kept logit is not finite")
    rows = prefill_agreement(summary, AGREEMENT_STEPS)
    for r in rows:
        print(f"decode step {r['step']} vs a fresh prefill of {args.prompt_len + r['step'] + 1}"
              f" tokens: scale-normalised err {r['err']:.3e} (tolerance {AGREEMENT_TOL}), "
              f"argmax agrees on {r['argmax_agree']}/{r['rows']} rows "
              f"(at least {AGREEMENT_MIN_ROWS})")
        if not (r["err"] <= AGREEMENT_TOL and r["argmax_agree"] >= AGREEMENT_MIN_ROWS):
            fail(f"decode step {r['step']} disagrees with a fresh prefill")
    print("first sequence:", tokens[0, :16].tolist(), "...")
    run = {"launches": {k: launches[k] for k in ("flash_attention", "decode_attention")},
           "prefill_s": summary["prefill_s"], "decode_s": summary["decode_s"],
           "decode_tok_s": summary["decode_tok_s"],
           "steady_decode_tok_s": summary["steady_decode_tok_s"],
           "max_memory_allocated_gib": peak / 2**30, "agreement": rows}
    return run, summary


def where_decode_time_goes(summary, *, steps: int = 16) -> dict:
    """Profile ``steps`` decode steps of the served model after a fresh
    prefill of the same prompts, from the third step."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.train.train_step import build_decode_step, build_prefill_step

    model = summary["model"]
    prompts = summary["prompts"].to(model.device)
    prompt_len = prompts.shape[1]
    logits, cache = build_prefill_step(model, summary["max_len"])({"tokens": prompts})
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    decode = build_decode_step(model)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(steps):
            with record_function(f"chip_smoke.decode{t}"):
                pass
            logits, cache = decode(cache, tok, prompt_len + t)
            tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
    print(f"decode steps 3-{steps}:")
    out = device_profile(prof, "chip_smoke.decode2", "decode_attention_kernel", steps - 2)
    out["steps"] = steps
    return out


def hybrid_path(argv) -> tuple[dict, dict]:
    """Drive ``repro_torch.launch.serve`` on zamba2 with ``argv``; check it;
    return its numbers and the run's summary (counts zeroed just before)."""
    import torch

    from repro_torch.launch.serve import build_parser, prefill_agreement, serve

    args = build_parser().parse_args(argv)
    steps = args.new_tokens - 1
    step = HYBRID_AGREEMENT_STEP
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    summary = serve(args, keep_logits=(step,), keep_states=(step - 1, step))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    cfg = summary["model"].cfg
    kinds = [kind for kind, _ in cfg.segments()]
    mamba = sum(count for kind, count in cfg.segments() if kind == "mamba2")
    sites = kinds.count("shared_attn")
    print(f"launches {launches}; params {summary['params']:,d} (cfg.param_count() "
          f"{cfg.param_count():,d}); prefill {summary['prefill_s']:.4f} s; decode "
          f"{summary['decode_s']:.4f} s for {steps} steps, {summary['decode_tok_s']:.1f} tok/s "
          f"(all steps), {summary['steady_decode_tok_s']:.1f} tok/s (steps 2-{steps}); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    want = {"ssd_scan": mamba, "flash_attention": sites, "decode_attention": sites * steps}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{name} launched {launches[name]} times, expected {n}")
    tokens = summary["tokens"]
    if tokens.shape != (args.batch, args.new_tokens) or not (
            (tokens >= 0) & (tokens < cfg.vocab_size)).all():
        fail(f"tokens {tuple(tokens.shape)} out of shape or range [0, {cfg.vocab_size})")
    if not all(bool(torch.isfinite(x).all())
               for x in (summary["prefill_logits"], summary["logits"][step])):
        fail("a kept logit is not finite")
    (row,) = prefill_agreement(summary, (step,))
    # The planted fault: step - 1's states held to the same fresh prefill.
    (stale,) = prefill_agreement({**summary, "states": {step: summary["states"][step - 1]}},
                                 (step,))
    row["stale_state_err"] = stale["state_err"]
    print(f"decode step {step} vs a fresh prefill of {args.prompt_len + step + 1} tokens: "
          f"logits scale-normalised err {row['err']:.3e} (tolerance {AGREEMENT_TOL}), argmax "
          f"agrees on {row['argmax_agree']}/{row['rows']} rows (at least {AGREEMENT_MIN_ROWS}); "
          f"{mamba} SSM states err {row['state_err']['ssm']:.3e} (tolerance "
          f"{HYBRID_STATE_TOL['ssm']}), conv states err {row['state_err']['conv']:.3e} "
          f"(tolerance {HYBRID_STATE_TOL['conv']}); planted fault, the states one token "
          f"stale: SSM err {stale['state_err']['ssm']:.3e}, conv err "
          f"{stale['state_err']['conv']:.3e}")
    if not all(stale["state_err"][k] > tol for k, tol in HYBRID_STATE_TOL.items()):
        fail("the state bound does not tell a state one token stale from a sound one")
    if not (row["err"] <= AGREEMENT_TOL and row["argmax_agree"] >= AGREEMENT_MIN_ROWS
            and all(row["state_err"][k] <= tol for k, tol in HYBRID_STATE_TOL.items())):
        fail(f"decode step {step} disagrees with a fresh prefill")
    print("first sequence:", tokens[0, :16].tolist(), "...")
    summary.pop("states")
    run = {"launches": {k: launches[k] for k in want}, "params": summary["params"],
           "param_count": cfg.param_count(), "prefill_s": summary["prefill_s"],
           "decode_s": summary["decode_s"], "decode_tok_s": summary["decode_tok_s"],
           "steady_decode_tok_s": summary["steady_decode_tok_s"],
           "max_memory_allocated_gib": peak / 2**30, "agreement": row}
    return run, summary


def where_prefill_time_goes(summary) -> dict:
    """Profile one prefill of the served model's prompts: ssd_scan's share
    of device time and its time per launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.train.train_step import build_prefill_step

    model = summary["model"]
    prompts = summary["prompts"].to(model.device)
    prefill = build_prefill_step(model, summary["max_len"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke.prefill"):
            pass
        prefill({"tokens": prompts})
        torch.cuda.synchronize()
    print("prefill:")
    return device_profile(prof, "chip_smoke.prefill", "ssd_scan_bf16_kernel", 1)


# --------------------------------------------------------------- phase 6
def small_reference(device) -> None:
    """Reduced tinyllama in f32 on ``device`` against the same weights on
    the CPU: logits (dense and chunked attention) and one train step."""
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


def small_serving(device, arch: str = "tinyllama-1.1b") -> list:
    """Reduced ``arch`` in f32: prefill + 12 greedy decode steps on
    ``device`` against the same weights on the CPU, with a full cache, a
    16-slot rotating window that the 24-token prompt overfills, and (for
    tinyllama) an int8 cache. Tokens equal; logits within SMALL_TOL
    (SMALL_INT8_TOL for int8)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.train.train_step import build_decode_step, build_prefill_step

    variants = (("full", {}, 16, 29), ("window", {"window": 16}, 24, 37))
    if arch == "tinyllama-1.1b":
        variants += (("int8", {"kv_cache_dtype": "int8"}, 16, 29),)
    out = []
    for name, changes, prompt_len, max_len in variants:
        cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
        cpu_model = build_model(cfg, device="cpu").init(0)
        prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, prompt_len))
        results = []
        for dev in ("cpu", device):
            model = build_model(cfg, device=dev)
            model.load_state_dict(cpu_model.state_dict())
            decode = build_decode_step(model)
            logits, cache = build_prefill_step(model, max_len)(
                {"tokens": torch.from_numpy(prompts.astype(np.int32)).to(dev)})
            logs = [logits[:, -1].double().cpu()]
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            toks = [tok.cpu()]
            for t in range(max_len - prompt_len - 1):
                logits, cache = decode(cache, tok, prompt_len + t)
                logs.append(logits[:, 0].double().cpu())
                tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
                toks.append(tok.cpu())
            results.append((torch.cat(toks, 1), logs))
        (tc, lc), (tg, lg) = results
        err = max(float((g - c).abs().max() / c.abs().max()) for g, c in zip(lg, lc))
        tol = SMALL_INT8_TOL if name == "int8" else SMALL_TOL
        print(f"{arch} serving {name}: {len(lg)} logits (prefill + {len(lg) - 1} decode "
              f"steps), max err {err:.3e} (tolerance {tol}); tokens equal: "
              f"{torch.equal(tc, tg)}")
        if not torch.equal(tc, tg) or not err <= tol:
            fail(f"{device} disagrees with the CPU on reduced {arch} serving ({name})")
        out.append({"arch": arch, "variant": name, "err": err})
    return out


# --------------------------------------------------------------- phase 8
class DataServer:
    """``repro_torch.launch.data_service --serve`` in a subprocess, on a
    store it builds under ``work``. It needs no card. Stopped by
    :meth:`stop`; :meth:`stderr` shows what it wrote to its standard
    error."""

    def __init__(self, work: Path):
        import os

        self.sock, self.store = work / "svc.sock", work / "store"
        self._out, self._err = work / "server.out", work / "server.err"
        env = dict(os.environ)
        env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
        with open(self._out, "w") as out, open(self._err, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.data_service", "--serve",
                 str(self.sock), "--store-dir", str(self.store), *DATA_SERVICE_ARGS],
                cwd=HERE, env=env, stdout=out, stderr=err,
            )

    def wait_ready(self, timeout: float = 300.0) -> None:
        deadline = time.monotonic() + timeout
        while "serving on" not in self._out.read_text():
            self.check_alive()
            if time.monotonic() > deadline:
                fail(f"the data server did not start serving in {timeout:.0f} s")
            time.sleep(0.2)
        print(self._out.read_text().strip())

    def check_alive(self) -> None:
        if self.proc.poll() is not None:
            fail(f"the data server exited early with code {self.proc.returncode}")

    def stderr(self) -> str:
        return self._err.read_text()

    def stop(self) -> None:
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)  # serve_forever stops on ^C
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


#: What phase 8 holds equal: a staged batch's grids; a ring frame's grids,
#: step and returned record ids.
GRID_KEYS = ("tokens", "targets", "loss_mask")
FRAME_KEYS = GRID_KEYS + ("step", "returned")


def batch_digest(batch, keys=GRID_KEYS) -> str:
    """A digest of a batch's ``keys`` (device or host tensors, numpy, ints)."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for k in keys:
        v = batch[k]
        v = v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
        h.update(k.encode() + str(v.dtype).encode() + str(v.shape).encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def host_digests(spec, store, steps=None, keys=GRID_KEYS) -> list:
    """Digests of an in-process loader's epoch 0 for ``spec`` on ``store``
    (its first ``steps`` batches, or all)."""
    from repro_torch.core import RedoxLoader

    batches = RedoxLoader.from_spec(spec, store).epoch(0)
    return [batch_digest(b, keys) for b in itertools.islice(batches, steps)]


def co_tenant(sock: Path, spec, start, trainer_done, out: dict) -> None:
    """Job ``job1``: once ``start`` is set, consume epoch 0 over its own
    ``RedoxClient``; after ``trainer_done``, read the server's stats."""
    from repro_torch.service.transport import RedoxClient

    try:
        if not start.wait(timeout=600):
            raise TimeoutError("the trainer never took its first batch")
        with RedoxClient(sock, spec, job_id="job1") as client:
            t0 = time.perf_counter()
            out["digests"] = [batch_digest(b, FRAME_KEYS) for b in client.epoch(0)]
            out["epoch_s"] = time.perf_counter() - t0
            if not trainer_done.wait(timeout=600):
                raise TimeoutError("the trainer did not finish")
            out["stats"] = client.stats()
    except Exception as e:  # the phase fails on it in the main thread
        out["error"] = e


def data_service_path() -> dict:
    """Phase 8: the trainer through a data server beside a co-tenant job,
    its profile, then the autotuned gather path."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        server = DataServer(Path(work))
        try:
            server.wait_ready()
            run = served_training(server)
            server.check_alive()
            run["profile"] = where_served_time_goes(server)
            server.check_alive()
        except BaseException:
            print(f"data server stderr:\n{server.stderr()}", file=sys.stderr, flush=True)
            raise
        finally:
            server.stop()
    run["autotune"] = autotuned_training()
    return run


def served_training(server: DataServer) -> dict:
    """Train through the server while ``job1`` consumes epoch 0 beside it;
    hold both streams to in-process loaders on the server's store. The
    co-tenant opens its session after the trainer's first batch, once the
    trainer's epoch is planned, so each job's plan is its solo one."""
    import threading

    import torch

    from repro_torch.core import ChunkStore, SessionSpec
    from repro_torch.launch.train import parse_args, train

    vocab, co_spec = 32000, SessionSpec(**CO_TENANT_SPEC)
    start, trainer_done, tenant = threading.Event(), threading.Event(), {}
    thread = threading.Thread(target=co_tenant, daemon=True,
                              args=(server.sock, co_spec, start, trainer_done, tenant))
    thread.start()
    staged = []

    def on_batch(step, feed):
        staged.append(batch_digest(feed))
        start.set()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        args = parse_args(SERVED_ARGS + ["--data-server", str(server.sock), "--workdir", work])
        torch.cuda.synchronize()
        zero_launches()
        try:
            summary = train(args, on_batch=on_batch)
        finally:
            launches = read_launches()
            start.set()
            trainer_done.set()
    thread.join(timeout=900)
    if thread.is_alive():
        fail("the co-tenant job did not finish epoch 0")
    if "error" in tenant:
        fail(f"the co-tenant job failed: {tenant['error']!r}")
    stats = summary["device_stats"]
    losses = summary["losses"]
    print(f"losses {losses}")
    print(f"tokens/sec {summary['tokens_per_s']:.1f} (whole run), "
          f"{summary['steady_tokens_per_s']:.1f} (steps 2-{len(losses)}); "
          f"{stats.steps} staged batches, {stats.kernel_steps} gathered on the card; "
          f"kernel launches {launches}")
    if len(losses) != args.steps or not all(math.isfinite(x) for x in losses):
        fail(f"expected {args.steps} finite losses, got {losses}")
    if abs(losses[0] - math.log(vocab)) > 2.0:
        fail(f"first loss {losses[0]} is not near ln({vocab}) at random init")
    if len(staged) != args.steps:
        fail(f"the trainer saw {len(staged)} staged batches, expected {args.steps}")
    if launches["chunk_gather_train"] != 0 or stats.kernel_steps != 0:
        fail(f"chunk_gather_train launched {launches['chunk_gather_train']} times on the "
             f"data-server path: ring frames ship assembled grids")
    store = ChunkStore.open(server.store)
    try:
        if staged != host_digests(summary["spec"], store, args.steps):
            fail("the trainer's batches through the server differ from an in-process "
                 "loader of its spec")
        want = host_digests(co_spec, store, keys=FRAME_KEYS)
    finally:
        store.close()
    if tenant["digests"] != want:
        fail(f"the co-tenant's {len(tenant['digests'])} batches differ from an in-process "
             f"loader of its spec ({len(want)} batches)")
    print(f"both streams equal their in-process loaders: trainer {len(staged)} batches, "
          f"co-tenant {len(want)} batches in {tenant['epoch_s']:.3f} s "
          f"({tenant['epoch_s'] / len(want) * 1e3:.3f} ms a frame, host)")
    rep = tenant["stats"]
    agg = rep["aggregate"]
    demand = {job: int(v) for job, v in rep["bytes_per_job"].items()}
    print(f"server: storage bytes read {agg['physical_bytes']:,d}, demand {demand} "
          f"(sum {sum(demand.values()):,d}); shared hits {agg['shared_hits']}, "
          f"shared bytes {agg['shared_bytes']:,d}, co-refill hits {agg['co_refill_hits']}")
    return {"losses": losses, "tokens_per_s": summary["tokens_per_s"],
            "steady_tokens_per_s": summary["steady_tokens_per_s"],
            "staged_batches": stats.steps, "gather_launches": launches["chunk_gather_train"],
            "storage_bytes": int(agg["physical_bytes"]), "demand_bytes": demand,
            "shared_hits": int(agg["shared_hits"]), "co_tenant_batches": len(want),
            "co_tenant_epoch_s": tenant["epoch_s"],
            "co_tenant_ms_per_frame": tenant["epoch_s"] / len(want) * 1e3}


def where_served_time_goes(server: DataServer) -> dict:
    """The data-server path's profile. It runs no gather: a staged batch is
    three pinned copies on the stager's side stream, which is found by
    them."""
    out, staged = profile_training(SERVED_ARGS + ["--data-server", str(server.sock)],
                                   "HtoD (Pinned")
    ops = out["stream_ops_per_launch"] * out["kernel_launches"] / staged
    print(f"{staged} staged batches: {ops:.2f} device operations a staged batch on the "
          f"stager's side stream")
    return {"idle_share": out["idle_share"], "window_ms": out["window_ms"],
            "busy_ms": out["busy_ms"], "ops_per_step": out["ops_per_step"],
            "side_stream_ops_per_batch": ops,
            "side_stream_us_per_batch":
                out["stream_us_per_launch"] * out["kernel_launches"] / staged}


def autotuned_training() -> dict:
    """``--autotune --device-path gather``: the trainer builds its store,
    calibrates it and reopens it with the chosen backend; every staged
    batch is gathered on the card and equals a loader's host stream on
    the reopened store."""
    import torch

    from repro_torch.core import ChunkStore
    from repro_torch.core.storage import make_backend
    from repro_torch.launch.train import parse_args, train

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        args = parse_args(AUTOTUNE_ARGS + ["--workdir", work])
        staged = []
        torch.cuda.synchronize()
        zero_launches()
        summary = train(args, on_batch=lambda step, feed: staged.append(batch_digest(feed)))
        launches = read_launches()
        choice, stats = summary["autotune"], summary["device_stats"]
        gathers = launches["chunk_gather_train"]
        print(f"autotune: {choice.describe()}; losses {summary['losses']}; "
              f"{stats.steps} staged batches; kernel launches {launches}")
        if gathers == 0 or gathers != stats.steps or gathers != stats.kernel_steps:
            fail(f"chunk_gather_train launched {gathers} times for {stats.steps} staged "
                 f"batches")
        if len(staged) != args.steps or not all(math.isfinite(x) for x in summary["losses"]):
            fail(f"expected {args.steps} staged batches and finite losses, got "
                 f"{len(staged)} and {summary['losses']}")
        kw = {"readahead": choice.readahead} if choice.readahead else {}
        store = ChunkStore.open(Path(work) / "chunks", backend=make_backend(choice.backend, **kw))
        try:
            if staged != host_digests(summary["spec"], store, args.steps):
                fail("the autotuned path's staged batches differ from the host stream of a "
                     "loader on the reopened store")
        finally:
            store.close()
        print(f"staged batches equal the host stream on the reopened store ({len(staged)} steps)")
    return {"backend": choice.backend, "readahead": choice.readahead,
            "cache_limit_bytes": choice.cache_limit_bytes, "fidelity": choice.fidelity,
            "predicted_epoch_s": choice.predicted_epoch_s, "losses": summary["losses"],
            "staged_batches": stats.steps, "gather_launches": gathers}


def build_all(packages=KERNEL_PACKAGES) -> None:
    """One nvcc per kernel package, all started together."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(packages)) as pool:
        futures = {name: pool.submit(build.build, name) for name in packages}
        logs = {name: f.result() for name, f in futures.items()}  # raises a failed build
    print(f"built {', '.join(packages)} in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        if log is None:
            print(f"  {name}: cached")
        for line in (log or "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {name}: {line.strip()}")


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--gathers", action="store_true",
                        help="run only phases 1-2 for chunk_gather, the gathers' timings "
                             "(launch floor, B = 8, the large shape, host time) and phase "
                             "4b's profile of the training stager; print them as JSON last")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"no port sources at {SRC / 'repro_torch'}")
    sys.path.insert(0, str(SRC))

    from repro_torch.kernels.common import resolve_device

    phase = PhaseClock()
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
    if args.gathers:
        build_all(("chunk_gather",))
        phase("3. the gathers' timings")
        times = time_gathers(device)
        print_gather_times(times)
        for name in ("chunk_gather_train", "chunk_gather"):
            times[name].pop("inputs")
        phase("4b. where the training path's device time goes (torch.profiler)")
        times["staging"] = where_time_goes(MAIN_ARGS)
        phase(None)
        print(card_line)
        print(json.dumps({"gathers": times}))
        return 0
    build_all()

    # ------------------------------------------------- 3. kernel parity
    phase("3. kernel parity (CUDA kernels vs plain PyTorch on the card)")
    check_chunk_gather(device)
    check_chunk_gather_raw(device)
    times = time_gathers(device)
    print_gather_times(times)
    kernels = {name: gather_row(name, times) for name in ("chunk_gather_train", "chunk_gather")}
    kernels["chunk_gather"].update(launches=0, main_path=None)
    check_attention_grid(device)
    kernels["flash_attention"] = check_flash_main(device)
    kernels["decode_attention"] = check_decode_main(device)
    check_ssd_grid(device)
    kernels["ssd_scan"] = check_ssd_main(device)
    torch.cuda.empty_cache()

    # ------------------------------------------------ 4. training path
    phase("4. training main path: repro_torch.launch.train " + " ".join(MAIN_ARGS))
    run = main_path(MAIN_ARGS, batch=8, seq_len=2048, vocab=32000)
    torch.cuda.empty_cache()

    phase("4b. where the training path's device time goes (torch.profiler)")
    run["profile"] = where_time_goes(MAIN_ARGS)
    if run["profile"]["side_stream_ops_per_batch"] != 2:
        fail(f"a staged batch takes {run['profile']['side_stream_ops_per_batch']} device "
             f"operations on the stager's side stream, not 2 (one copy and the gather)")
    torch.cuda.empty_cache()

    # ------------------------------------------------- 5. serving path
    phase("5. serving main path: repro_torch.launch.serve " + " ".join(SERVE_ARGS))
    serve_run, summary = serve_path(SERVE_ARGS)

    phase("5b. where decode's device time goes (torch.profiler)")
    serve_run["decode_profile"] = where_decode_time_goes(summary)
    del summary
    torch.cuda.empty_cache()

    # -------------------------------------- 6. small-input reference check
    phase("6. reduced tinyllama and zamba2 f32: card vs CPU on the same weights")
    small_reference(device)
    serve_run["small_serving"] = small_serving(device)
    small_hybrid = small_serving(device, "zamba2-1.2b")

    # ---------------------------------------------- 7. hybrid serving path
    phase("7. hybrid serving main path: repro_torch.launch.serve " + " ".join(HYBRID_ARGS))
    hybrid_run, summary = hybrid_path(HYBRID_ARGS)
    hybrid_run["small_serving"] = small_hybrid

    phase("7b. where the hybrid's prefill and decode device time goes (torch.profiler)")
    hybrid_run["prefill_profile"] = where_prefill_time_goes(summary)
    hybrid_run["decode_profile"] = where_decode_time_goes(summary)
    del summary
    torch.cuda.empty_cache()

    # ------------------------------------------------ 8. data-service path
    phase("8. data-service main path: repro_torch.launch.data_service --serve and "
          "repro_torch.launch.train " + " ".join(SERVED_ARGS) + " --data-server SOCK; "
          + " ".join(AUTOTUNE_ARGS))
    ds_run = data_service_path()
    ds_run["main_path_profile"] = {k: run["profile"][k] for k in
                                   ("idle_share", "ops_per_step", "side_stream_ops_per_batch")}
    ds_run["main_path_steady_tokens_per_s"] = run["steady_tokens_per_s"]
    torch.cuda.empty_cache()
    phase(None)

    # Launches in the main paths' runs: flash and decode run in both serving
    # paths, ssd_scan in the hybrid's; the raw gather is on no path.
    by_path = {"serve_path": serve_run["launches"], "hybrid_path": hybrid_run["launches"]}
    for name in ("flash_attention", "decode_attention", "ssd_scan"):
        counts = {path: launches[name] for path, launches in by_path.items() if name in launches}
        kernels[name]["launches"] = sum(counts.values())
        kernels[name]["launches_by_path"] = counts
    # The training gather runs on phase 4's path and phase 8's autotuned
    # one; the data-server path ships assembled grids and launches none.
    counts = {"main_path": run["launches"], "data_service_path": ds_run["gather_launches"],
              "autotune_path": ds_run["autotune"]["gather_launches"]}
    kernels["chunk_gather_train"]["launches"] = sum(counts.values())
    kernels["chunk_gather_train"]["launches_by_path"] = counts

    # ----------------------------------------------------------- result
    print(f"phase wall times, s: {json.dumps({k: round(v, 1) for k, v in phase.times.items()})}")
    print(json.dumps({"main_path": run}))
    print(json.dumps({"serve_path": serve_run}))
    print(json.dumps({"hybrid_path": hybrid_run}))
    print(json.dumps({"data_service_path": ds_run}))
    print(card_line)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
