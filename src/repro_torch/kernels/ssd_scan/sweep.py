"""Sweep of the bf16 ssd_scan kernel's heads a block (G) and ring depth.

    PYTHONPATH=src python -m repro_torch.kernels.ssd_scan.sweep [--out FILE]

``ssd_scan.cu`` commits one configuration. This builds copies of it with
``kGroup`` in {1, 2, 4} and ``kStages`` in {2, 3} (one ``nvcc`` each, all
started together, under ``build/kernels/sweep/``), runs each at Zamba2's
prefill shape (x (8, 3584, 64, 64) bf16 strided in the conv output, B/C
(8, 3584, 64)), checks that every variant's y and final state equal the
committed kernel's bit for bit (the configuration moves work between warps
and copies, not arithmetic), and times them in turns on one card: CUDA
events around a CUDA graph of 10 calls, forward order then reverse, the
median over both passes. Prints one line per variant and a JSON summary.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
import statistics
import subprocess

import torch
import torch.nn.functional as F

from .. import build
from . import ops

VARIANTS = [(g, st) for g in (1, 2, 4) for st in (2, 3)]
SWEEP_DIR = build.BUILD_DIR / "sweep"


def _variant_source(group: int, stages: int) -> str:
    src = (build.KERNEL_DIR / "ssd_scan" / "ssd_scan.cu").read_text()
    for name, value in (("kGroup", group), ("kStages", stages)):
        src, count = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                             src)
        if count != 1:
            raise RuntimeError(f"ssd_scan.cu does not define {name} exactly once")
    return src


def _build(group: int, stages: int) -> tuple[ctypes.CDLL, str]:
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    cu = SWEEP_DIR / f"ssd_scan_g{group}_s{stages}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(_variant_source(group, stages))
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for G={group} stages={stages}:\n{proc.stdout}")
    lib = ctypes.CDLL(str(so))
    ours = ops._lib()
    for fn in ("ssd_scan_launch", "ssd_scan_heads_per_block", "ssd_scan_error_string"):
        getattr(lib, fn).argtypes = getattr(ours, fn).argtypes
        getattr(lib, fn).restype = getattr(ours, fn).restype
    usage = [line.strip() for line in proc.stdout.splitlines()
             if "bf16" in line or "registers" in line or "spill" in line]
    return lib, " | ".join(usage)


def _inputs(device):
    b, s, h, p, n = 8, 3584, 64, 64, 64
    gen = torch.Generator(device=device).manual_seed(3)
    xbc = F.silu(torch.randn(b, s, h * p + 2 * n, generator=gen, device=device)).bfloat16()
    xh = xbc[..., : h * p].reshape(b, s, h, p)
    bm, cm = xbc[..., h * p : h * p + n], xbc[..., h * p + n :]
    dt = F.softplus(torch.randn(b, s, h, generator=gen, device=device))
    a = -torch.linspace(1.0, 16.0, h, device=device)
    return xh, dt, a, bm, cm


def _runner(lib, xh, dt, a, bm, cm):
    bsz, s, h, p = xh.shape
    n = bm.shape[-1]
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=xh.device)
    final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=xh.device)
    strides = (*xh.stride()[:3], *dt.stride(), 0, a.stride(0), *bm.stride()[:2],
               *cm.stride()[:2], *y.stride()[:3])
    arr = (ctypes.c_longlong * len(strides))(*strides)
    width = ops.copy_width(xh, bm, cm)

    def run():
        rc = lib.ssd_scan_launch(
            xh.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            y.data_ptr(), None, final.data_ptr(), bsz, h, s, p, n, arr, len(strides), 1, width,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: {lib.ssd_scan_error_string(rc)}")

    return run, y, final


def _graph_ms(run, calls: int = 10, reps: int = 5) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            run()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / calls)
    return statistics.median(samples)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON summary here")
    args = parser.parse_args(argv)
    device = torch.device("cuda")
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda v: _build(*v), VARIANTS)))
    inputs = _inputs(device)
    committed = torch.cat([t.flatten() for t in ops.ssd_scan_heads(*inputs)])
    runs = {}
    for v in VARIANTS:
        lib, usage = built[v]
        if lib.ssd_scan_heads_per_block() != v[0]:
            raise RuntimeError(f"variant {v} reports G={lib.ssd_scan_heads_per_block()}")
        run, y, final = _runner(lib, *inputs)
        run()
        torch.cuda.synchronize()
        equal = torch.equal(torch.cat([y.flatten(), final.flatten()]), committed)
        runs[v] = (run, usage, equal)
    times = {v: [] for v in VARIANTS}
    for order in (VARIANTS, VARIANTS[::-1]):
        for v in order:
            times[v].append(_graph_ms(runs[v][0]))
    rows = []
    for v in VARIANTS:
        run, usage, equal = runs[v]
        ms = statistics.median(times[v])
        rows.append({"group": v[0], "stages": v[1], "ms": ms, "runs_ms": times[v],
                     "equal_to_committed": equal, "ptxas": usage})
        print(f"G={v[0]} stages={v[1]}: {ms:.4f} ms ({times[v][0]:.4f} / {times[v][1]:.4f}); "
              f"equal to the committed kernel: {equal}; {usage}")
    summary = {"ssd_scan_sweep": rows, "device": torch.cuda.get_device_name(0)}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)
    return 0 if all(r["equal_to_committed"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
