"""The port's dry run beside the JAX package's, for PERF.md (not a test).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_dryrun_vs_jax.py

Runs the reference's miniature dry run (``tests/test_sharding_dryrun.py``'s
cells: tinyllama, deepseek-moe and zamba2 at ``reduced``, ``train_4k`` cut
to S = 256 and B = 8, a (2, 4) ("data", "model") mesh) in a subprocess on 8
emulated CPU devices with ``Auto`` mesh axes, and the port's on a (2, 4)
mesh of a fake 8-rank group in another, then prints one markdown row a
cell: FLOPs per device and collective bytes per device on each side and
their ratios. HLO counts every dot (and the port counts every matmul-like
op) after each side's own partitioning, so the ratio is a reading, not a
gate. Each side's subprocess has a 900 s limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("tinyllama-1.1b", "deepseek-moe-16b", "zamba2-1.2b")

COMMON = textwrap.dedent("""
    import dataclasses, json
    SMALL_ARCHS = {archs!r}
""")

JAX_SIDE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro.launch import dryrun_lib
    from repro.configs import ARCHS, reduced, get_shape

    small = dataclasses.replace(get_shape("train_4k"), seq_len=256, global_batch=8)
    dryrun_lib.get_config = lambda name: reduced(ARCHS[name])
    dryrun_lib.get_shape = lambda name: small
    auto = (jax.sharding.AxisType.Auto,) * 2
    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=auto)
    out = {}
    for arch in SMALL_ARCHS:
        r = dryrun_lib.run_cell(arch, "train_4k", mesh)
        out[arch] = r.to_json()
    print("RESULT " + json.dumps(out))
""")

PORT_SIDE = textwrap.dedent("""
    from repro_torch.launch.dryrun import init_fake_world
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.configs import ARCHS, reduced, get_shape

    small = dataclasses.replace(get_shape("train_4k"), seq_len=256, global_batch=8)
    dryrun_lib.get_config = lambda name: reduced(ARCHS[name])
    dryrun_lib.get_shape = lambda name: small
    init_fake_world(8)
    mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
    out = {}
    for arch in SMALL_ARCHS:
        out[arch] = dryrun_lib.run_cell(arch, "train_4k", mesh).to_json()
    print("RESULT " + json.dumps(out))
""")


def _side(body: str) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", COMMON.format(archs=ARCHS) + body],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=900)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if not line:
        raise SystemExit(f"no result line; stderr tail: {proc.stderr[-3000:]}")
    return json.loads(line[0][len("RESULT "):])


def main() -> int:
    ref, port = _side(JAX_SIDE), _side(PORT_SIDE)
    print("| cell (reduced, S 256, B 8, 2x4) | JAX FLOPs/dev | port FLOPs/dev | ratio "
          "| JAX coll B/dev | port coll B/dev | ratio | port coll by kind |")
    print("|---|---|---|---|---|---|---|---|")
    for arch in ARCHS:
        r, p = ref[arch], port[arch]
        if r["status"] != "ok" or p["status"] != "ok":
            print(f"| {arch} | {r['status']} {r['error'][:80]} | {p['status']} "
                  f"{p['error'][:80]} | | | | | |")
            continue
        rc, pc = r["collectives"]["total_bytes"], p["collectives"]["total_bytes"]
        kinds = {k: v for k, v in p["collectives"].items() if k not in ("total_bytes", "num_ops")}
        print(f"| {arch} | {r['flops_per_device']:.4e} | {p['flops_per_device']:.4e} "
              f"| {p['flops_per_device'] / r['flops_per_device']:.3f} | {rc:.4e} | {pc:.4e} "
              f"| {pc / rc:.3f} | {json.dumps(kinds)} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
