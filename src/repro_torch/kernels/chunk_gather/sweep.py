"""Sweep of the gathers' block size (kThreads) and run length (kRun).

    PYTHONPATH=src python -m repro_torch.kernels.chunk_gather.sweep [--out FILE]

``chunk_gather.cu`` commits one configuration. This builds copies of it
with ``kThreads`` in {32, 64, 128, 256, 512} and ``kRun`` in {4, 8, 16} tokens
a thread (one ``nvcc`` each, all started together, under
``build/kernels/sweep/``), runs each through the port's own wrappers,
checks every variant against the plain versions exactly (the trainer's
shape, a scalar-path view at offset 1, the large shape), and times them
in turns on one card with ``common.graph_ms`` (CUDA events around a CUDA
graph of 50 calls), forward order then reverse, the median over both
passes. Shapes: ``chunk_gather_train`` at the trainer's B = 8, S = 2048,
Lp = 2056 (inputs hot in the L2, as the trainer's are) and at the large
shape of ``chip_smoke.py`` (``train_4k`` staged as one batch, B = U = 256,
S = 4096, Lp = 4104, its 8 input sets rotated and every output kept, so
that no call finds its bytes in the L2); the raw ``chunk_gather`` at
B = 8, L = 2176. The launch floor (a one-element ``fill_`` in the same
harness) is timed before and after. Prints one line per variant and a
JSON summary.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import importlib.util
import itertools
import json
import re
import statistics
import subprocess
from unittest import mock

import torch

from .. import build, parity
from ..common import graph_ms
from . import ops
from .ref import chunk_gather_ref, chunk_gather_train_ref

VARIANTS = [(t, r) for t in (32, 64, 128, 256, 512) for r in (4, 8, 16)]
SWEEP_DIR = build.BUILD_DIR / "sweep"


def _variant_source(threads: int, run: int) -> str:
    src = (build.KERNEL_DIR / "chunk_gather" / "chunk_gather.cu").read_text()
    for name, value in (("kThreads", threads), ("kRun", run)):
        src, count = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                             src)
        if count != 1:
            raise RuntimeError(f"chunk_gather.cu does not define {name} exactly once")
    return src


def _build(threads: int, run: int) -> tuple[ctypes.CDLL, str]:
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    cu = SWEEP_DIR / f"chunk_gather_t{threads}_r{run}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(_variant_source(threads, run))
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for kThreads={threads} kRun={run}:\n{proc.stdout}")
    usage = [line.strip() for line in proc.stdout.splitlines()
             if "registers" in line or "spill" in line]
    return ops._bind(ctypes.CDLL(str(so))), " | ".join(sorted(set(usage)))


def _large_sets(device) -> tuple[int, list]:
    """The large shape's input sets, from ``chip_smoke.py`` at the
    checkout's root (one definition for the smoke and the sweep)."""
    path = build.KERNEL_DIR.parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.large_gather_sets(device)


def _equal(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON summary here")
    args = parser.parse_args(argv)
    device = torch.device("cuda")
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda v: _build(*v), VARIANTS)))
    case = parity.KernelCase("chunk_gather_train", (8, 2048, 8), "int32")
    train_in = parity.make_inputs(case, device=device, row_pad=8)
    raw_in = parity.make_inputs(parity.KernelCase("chunk_gather", (8, 2176, 8), "int32"),
                                device=device)
    s, sets = _large_sets(device)
    flat = torch.cat([train_in[0].flatten(), train_in[0].new_zeros(1)])
    odd = (flat[1:].view(train_in[0].shape), *train_in[1:])  # the scalar path
    keep = []
    cycle = itertools.cycle(sets)
    calls = {"train": lambda: ops.chunk_gather_train(*train_in, seq_len=2048),
             "raw": lambda: ops.chunk_gather(*raw_in),
             "large": lambda: keep.append(ops.chunk_gather_train(*next(cycle), seq_len=s))}
    equal = {}
    for v in VARIANTS:
        with mock.patch.object(ops, "_lib", lambda lib=built[v][0]: lib):
            equal[v] = (all(_equal(ops.chunk_gather_train(*inp, seq_len=n),
                                   chunk_gather_train_ref(*inp, seq_len=n))
                            for inp, n in ((train_in, 2048), (odd, 2048), (sets[0], s)))
                        and _equal(ops.chunk_gather(*raw_in), chunk_gather_ref(*raw_in)))
    one = torch.empty(1, device=device)
    floor = [graph_ms(lambda: one.fill_(1.0), calls=50, reps=10)]
    times = {v: {k: [] for k in calls} for v in VARIANTS}
    for order in (VARIANTS, VARIANTS[::-1]):
        for v in order:
            with mock.patch.object(ops, "_lib", lambda lib=built[v][0]: lib):
                for k, call in calls.items():
                    times[v][k].append(graph_ms(call, calls=50, reps=10))
                    keep.clear()
    floor.append(graph_ms(lambda: one.fill_(1.0), calls=50, reps=10))
    print(f"launch floor: {floor[0] * 1e3:.3f} / {floor[1] * 1e3:.3f} us (before / after)")
    rows = []
    for v in VARIANTS:
        row = {"threads": v[0], "run": v[1], "equal_to_plain": equal[v], "ptxas": built[v][1]}
        for k, t in times[v].items():
            row[f"{k}_us"] = statistics.median(t) * 1e3
            row[f"{k}_runs_us"] = [x * 1e3 for x in t]
        rows.append(row)
        print(f"kThreads={v[0]} kRun={v[1]}: train B=8 {row['train_us']:.3f} us, raw B=8 "
              f"{row['raw_us']:.3f} us, large {row['large_us']:.3f} us "
              f"({' / '.join(f'{x:.3f}' for x in row['large_runs_us'])}); equal to the plain "
              f"versions: {row['equal_to_plain']}; {row['ptxas']}")
    summary = {"chunk_gather_sweep": rows, "floor_runs_us": [x * 1e3 for x in floor],
               "device": torch.cuda.get_device_name(0)}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
