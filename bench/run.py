"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload hubert-xlarge.frames2k --seed 7 --seconds 30 --trace 0

From the root of a checkout, on a machine with the cell's CUDA cards.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled window. The last line of standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit); the checks are also the last lines of
standard error. Without a card, or with fewer than the cell asks for, it
exits 2 and prints no result; if JAX or the JAX package was loaded by the
time the window closed, it exits 3.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _err(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules(names=None) -> list:
    """Of ``names`` (the loaded modules by default), the top-level names
    that are JAX's, jaxlib's, flax's or the JAX package's, compared whole:
    ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")

    # the script's own folder first on the path would shadow the standard
    # library with the harness's modules
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != ROOT / "bench"]
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from bench import harness

    manifest = harness.load_manifest(ROOT)
    cell = harness.load_cell(args.workload, manifest, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _err(f"{args.workload} needs {cell.chips} CUDA card(s); "
             f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.init()
    _err(f"set-up: torch and the card's context at {time.perf_counter() - _T_START:.3f} s")
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device=device,
                           log=_err)
    setup_s = res["window_open"] - _T_START
    # read after the window, so that the query is no part of set-up
    power = power_limit_w()
    bad = forbidden_modules()
    if bad:
        _err(f"loaded by the time the window closed: {bad}; the port must not need them")
        return 3

    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips, "memory_peak_bytes": res["peak_bytes"],
                   "power_limit_w": power}
    if args.trace:
        metrics = {n: {"value": v, "unit": u} for n, (v, u) in res["per_layer"].items()}
        prof = res["profile"] or {}
        device_info.update(busy_s=prof.get("busy_s", 0.0), window_s=res["window_s"])
    else:
        e2e = dict(res["end_to_end"], setup_s=(setup_s, "s"))
        wanted = [m["name"] for m in manifest["end_to_end"]
                  if "workloads" not in m or args.workload in m["workloads"]]
        metrics = {n: {"value": e2e[n][0], "unit": e2e[n][1]} for n in wanted}
    result = {"correct": res["correct"], "attempted": res["attempted"],
              "failed": res["failed"], "metrics": metrics, "device": device_info}
    if args.trace:
        result["breakdown"] = {"device_ops": prof.get("device_ops", []),
                               "idle_gaps": prof.get("idle_gaps", [])}
    result["checks"] = res["checks"]
    _err(f"set-up {setup_s:.3f} s; window {res['window_s']:.3f} s; "
         f"peak {res['peak_bytes'] / 2**30:.3f} GiB; {device_info['kind']}, {power} W")
    for name, c in res["checks"].items():
        _err(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
