"""Multi-pod dry-run driver (``repro/launch/dryrun.py``).

For every live (arch × shape) cell, run the appropriate step on DTensors
over meta tensors on the single-pod 16x16 mesh and the 2x16x16 multi-pod
mesh, print FLOPs, collective bytes and temp bytes per device, and append
a JSON record per cell to the artifact file (incremental: already-recorded
cells are skipped, so the sweep is restartable). Where the reference
emulates 512 devices through ``XLA_FLAGS``, this joins a fake process
group of 512 ranks (torch's ``FakeStore`` / ``"fake"`` backend: the
collectives move no data) as rank 0.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod-only
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch.distributed as dist

from ..configs import SHAPES, list_archs
from .dryrun_lib import optimized_run_cfg, run_cell
from .mesh import make_production_mesh

WORLD = 512


def init_fake_world(world_size: int = WORLD) -> None:
    """Join a fake process group of ``world_size`` ranks as rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape name (default: all)")
    ap.add_argument("--out", default="artifacts/dryrun.jsonl")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument(
        "--optimized", action="store_true",
        help="use the §Perf-optimized per-arch configs instead of the "
             "paper-faithful baseline recipe",
    )
    args = ap.parse_args()

    init_fake_world()
    assert dist.get_world_size() == WORLD, "dryrun requires 512 fake ranks"

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    done = set()
    if out_path.exists():
        for line in out_path.read_text().splitlines():
            r = json.loads(line)
            done.add((r["arch"], r["shape"], r["mesh"]))

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = []
    if not args.multi_pod_only:
        meshes.append(make_production_mesh(multi_pod=False, device_type="cpu"))
    if not args.single_pod_only:
        meshes.append(make_production_mesh(multi_pod=True, device_type="cpu"))

    failures = 0
    with open(out_path, "a") as fh:
        for mesh in meshes:
            for arch in archs:
                for shape in shapes:
                    mesh_name = "x".join(f"{k}{v}" for k, v in mesh.shape.items())
                    key = (arch, shape, mesh_name)
                    if key in done:
                        continue
                    if args.optimized:
                        rc, cfg_ov = optimized_run_cfg(arch)
                        res = run_cell(arch, shape, mesh, run_cfg=rc, cfg_override=cfg_ov)
                    else:
                        res = run_cell(arch, shape, mesh)
                    rec = res.to_json()
                    fh.write(json.dumps(rec) + "\n")
                    fh.flush()
                    tag = res.status if res.status != "ok" else (
                        f"ok  {res.compile_s:6.1f}s  flops/dev={res.flops_per_device:.3e}"
                        f"  coll/dev={res.collectives['total_bytes']:.3e}B"
                        f"  temp/dev={res.memory['temp_size_in_bytes']/1e9:.2f}GB"
                    )
                    print(f"[{mesh_name}] {arch} × {shape}: {tag}", flush=True)
                    if res.status == "FAILED":
                        failures += 1
                        print("   ", res.error[:500], flush=True)
    dist.destroy_process_group()
    print(f"dry-run complete; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
