"""The readings a cell's limits are set from, over many seeds in one process.

    python3 bench/control.py --workload hubert-xlarge.frames2k \
        --seeds 11 12 13 14 15 16 17 18 --control-seeds 11 12 13

For each of ``--seeds`` the program is set up as a benchmark run sets it
up and trains its first three steps through the timed path; they are
compared with the f32 reference (``program``: the lower readings). For each
of ``--control-seeds`` also:

- ``control``: the reference itself in the program's place, computed with
  float8 e4m3 products (the step below the configuration's bf16), against
  the f32 reference;
- ``half_batch``: the reference on the first half of each batch's rows,
  the loss the mean over those (a planted fault), against the f32
  reference;
- ``token_altered``: the program again with one token of every staged
  batch altered where the gather produces it, read by the data check.

A step that returns its state unchanged reads a change gap of 1 and needs
no run. Each reading is a JSON line on standard output. Runs on the card
(``--device cpu`` for a rehearsal at the file's sizes: slow).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def token_altered():
    """Every training gather's output with token (0, 0) changed: planted in
    the program where its tokens are produced."""
    from repro_torch.core import device as staging

    real = staging.chunk_gather_train

    def altered(*a, **kw):
        tokens, targets, mask = real(*a, **kw)
        tokens[0, 0] += 1
        return tokens, targets, mask

    staging.chunk_gather_train = altered
    try:
        yield
    finally:
        staging.chunk_gather_train = real


def program_readings(harness, cell, seed, device) -> tuple:
    """The program's first three steps on ``seed``: its readings, and the
    data check of their batches."""
    with tempfile.TemporaryDirectory(prefix="bench-control-") as work:
        prog = harness.Program(cell, seed, device, Path(work))
        first = harness.first_steps(prog)
        data = prog.data
        prog.close()
        del prog
    for b in first["batches"]:
        b.to_host()
    faults = harness.data_faults(first["batches"], data, cell.mix)
    gc.collect()
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()
    return first, faults


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the script's own folder first on the path would shadow the standard
    # library with the harness's modules
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != ROOT / "bench"]
    import torch

    from bench import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    cell = harness.load_cell(args.workload)
    half = slice(0, cell.mix["batch"] // 2)

    def emit(kind, seed, reading, t0):
        print(json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                          "seconds": time.perf_counter() - t0, **reading}), flush=True)

    for seed in args.seeds:
        t0 = time.perf_counter()
        first, faults = program_readings(harness, cell, seed, device)
        ref = harness.reference_readings(cell, seed, first["batches"], device)
        emit("program", seed, dict(harness.model_gaps(first, ref), data=faults,
                                   losses=first["losses"], ref_losses=ref["losses"]), t0)
        if seed not in args.control_seeds:
            continue
        t0 = time.perf_counter()
        low = harness.reference_readings(cell, seed, first["batches"], device, "fp8")
        emit("control", seed, dict(harness.model_gaps(low, ref), losses=low["losses"]), t0)
        t0 = time.perf_counter()
        cut = harness.reference_readings(cell, seed, first["batches"], device, rows=half)
        emit("half_batch", seed, dict(harness.model_gaps(cut, ref), losses=cut["losses"]), t0)
        t0 = time.perf_counter()
        with token_altered():
            _, faults = program_readings(harness, cell, seed, device)
        emit("token_altered", seed, {"data": faults}, t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
