"""Nothing a run loads is JAX, jaxlib, flax or the JAX package: checked in a
fresh interpreter that loads every cell and drives one through the harness
on the CPU, comparing top-level module names whole."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
sys.path.insert(0, sys.argv[1] + "/bench/tests")
from bench import harness, control, run, trace_reduce
from conftest import tiny_cell
manifest = harness.load_manifest()
for w in manifest["workloads"]:
    cell = harness.load_cell(w["name"], manifest)
    harness.program_config(cell)
    for m in cell.per_layer:
        harness._metric_reader(m["name"])
for w in ("hubert-xlarge.frames512", "zamba2-1.2b.tokens2k"):
    harness.run_cell(tiny_cell(w), 5, 0.1, True, device="cpu", log=lambda *a: None)
print(json.dumps(run.forbidden_modules()))
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)], capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_whole_top_level_names():
    from bench import run

    assert run.forbidden_modules(["repro_torch", "repro_torch.core", "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["repro.core.loader", "jax._src", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]
