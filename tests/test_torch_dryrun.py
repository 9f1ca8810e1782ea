"""The port's dry run (``repro_torch.launch.dryrun_lib``) on fake meshes.

Each case runs in a subprocess of its own, which joins a fake process
group (torch's ``FakeStore``: collectives move no data) and runs on meta
tensors:

- the FLOP count of a sharded matmul is the local shard's: [256x2048] @
  [2048x5632] as [Shard(0), Replicate()] x [Replicate(), Shard(1)] on a
  16x32 mesh of 512 ranks is 2*16*2048*176 = 11,534,336 FLOPs per device,
  where a ``FlopCounterMode`` over the DTensor op reads the global
  5,905,580,032;
- tinyllama, deepseek-moe and zamba2 at ``reduced``, ``train_4k`` cut to
  S = 256 and B = 8, on a (2, 4) mesh, each ``ok`` with FLOPs and
  collective bytes above zero (the reference's own miniature dry run),
  and its row read by both roofline modules;
- tinyllama's prefill and decode cells, cut the same way, ``ok`` too;
- under ``parallelism="dp_only"`` every device runs one eighth of the
  batch, so its FLOPs times 8 equal, exactly, those of the same train
  step on plain meta tensors counted by ``FlopCounterMode``.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]

PRELUDE = textwrap.dedent("""
    import dataclasses, json, torch, torch.distributed as dist
    from repro_torch.launch.dryrun import init_fake_world
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.configs import ARCHS, RunConfig, reduced, get_shape

    SMALL = dataclasses.replace(get_shape("train_4k"), seq_len=256, global_batch=8)
    dryrun_lib.get_config = lambda name: reduced(ARCHS[name])
    dryrun_lib.get_shape = lambda name: dataclasses.replace(get_shape(name), seq_len=256,
                                                            global_batch=8)
""")


def _run(body: str, timeout: int = 240) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", PRELUDE + textwrap.dedent(body)],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=timeout)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, f"no result line; stderr tail: {proc.stderr[-3000:]}"
    return json.loads(line[0][len("RESULT "):])


def test_flops_of_a_sharded_matmul_are_the_local_shards():
    out = _run("""
        from torch.distributed.tensor import Replicate, Shard
        from torch.utils.flop_counter import FlopCounterMode
        init_fake_world(512)
        mesh = make_mesh((16, 32), ("data", "model"), device_type="cpu")
        a = dryrun_lib.distribute(torch.empty(256, 2048, device="meta"), mesh,
                                  (Shard(0), Replicate()))
        b = dryrun_lib.distribute(torch.empty(2048, 5632, device="meta"), mesh,
                                  (Replicate(), Shard(1)))
        with dryrun_lib.count_local() as c:
            y = a @ b
        with FlopCounterMode(display=False) as fc:
            a @ b
        print("RESULT " + json.dumps({"local": c.counts["flops"], "mode": fc.get_total_flops(),
                                      "placements": str(y.placements),
                                      "local_shape": list(y.to_local().shape)}))
    """)
    assert out["local"] == 2 * 16 * 2048 * 176 == 11_534_336
    assert out["mode"] >= 256 * 2048 * 5632 * 2 > out["local"]
    assert out["local_shape"] == [16, 176]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-moe-16b", "zamba2-1.2b"])
def test_reduced_train_cell_runs_on_a_2x4_fake_mesh(arch):
    out = _run(f"""
        init_fake_world(8)
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        r = dryrun_lib.run_cell({arch!r}, "train_4k", mesh)
        print("RESULT " + json.dumps(r.to_json()))
    """)
    assert out["status"] == "ok", out["error"]
    assert out["step_kind"] == "train_step" and out["mesh"] == "data2xmodel4"
    assert out["flops_per_device"] > 0 and out["collectives"]["total_bytes"] > 0
    assert out["bytes_per_device"] > 0 and out["memory"]["temp_size_in_bytes"] > 0
    assert out["memory"]["argument_size_in_bytes"] > 0
    print(arch, json.dumps({k: out[k] for k in ("flops_per_device", "collectives", "memory")}))
    # both roofline modules read the port's artifact row
    from repro.launch import roofline as jroof
    from repro_torch.launch import roofline

    for mod in (roofline, jroof):
        (row,) = mod.analyze([out])
        assert row["status"] == "ok" and row["compute_s"] > 0 and row["collective_s"] > 0


@pytest.mark.parametrize("shape,kind", [("prefill_32k", "serve_prefill"),
                                        ("decode_32k", "serve_decode")])
def test_reduced_serving_cells_run_on_a_2x4_fake_mesh(shape, kind):
    out = _run(f"""
        init_fake_world(8)
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        r = dryrun_lib.run_cell("tinyllama-1.1b", {shape!r}, mesh)
        print("RESULT " + json.dumps(r.to_json()))
    """)
    assert out["status"] == "ok", out["error"]
    assert out["step_kind"] == kind
    assert out["flops_per_device"] > 0 and out["collectives"]["total_bytes"] > 0


def test_dp_only_flops_are_an_eighth_of_the_unsharded_step():
    out = _run("""
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.launch.specs import train_input_specs
        from repro_torch.models.transformer import Model
        from repro_torch.optim.optimizers import make_optimizer
        from repro_torch.train.train_step import build_train_step, fresh_train_state

        init_fake_world(8)
        run_cfg = RunConfig(parallelism="dp_only", remat="full", zero1=True)
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        r = dryrun_lib.run_cell("tinyllama-1.1b", "train_4k", mesh, run_cfg=run_cfg)
        cfg = reduced(ARCHS["tinyllama-1.1b"])
        model = Model(cfg, device="meta")
        opt = make_optimizer(run_cfg)
        state = fresh_train_state(model, opt)
        batch = train_input_specs(cfg, SMALL)
        with FlopCounterMode(display=False) as fc:
            build_train_step(model, run_cfg, opt)(state, batch)
        print("RESULT " + json.dumps({"status": r.status, "error": r.error,
                                      "per_device": r.flops_per_device,
                                      "unsharded": fc.get_total_flops()}))
    """)
    assert out["status"] == "ok", out["error"]
    assert out["unsharded"] > 0
    assert out["per_device"] * 8 == out["unsharded"]
