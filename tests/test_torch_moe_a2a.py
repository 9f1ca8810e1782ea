"""The port's ``moe_block_a2a`` against the JAX package's, on 8 ranks.

Reduced deepseek-moe-16b (d_model 128, 8 routed experts, top-2, one
shared expert), f32, x of shape (4, 64, d) from numpy seed 0, the
reference's own init moved across as numpy. The JAX side runs in a
subprocess on 8 emulated CPU devices with a (2, 4) ("data", "model") mesh
of ``Auto`` axes (jax's default axis type is ``Explicit``, under which the
reference's ``with_sharding_constraint`` refuses the mesh). The port runs
on 8 gloo ranks, spawned from a subprocess, on a (2, 4) mesh of its own.

- At capacity factor 1.25 the per-pair stage drops assignments (3 of
  512 at this seed) and the output differs from ``moe_block``'s by about
  0.5: the drops decide it. There the port's a2a equals the JAX a2a
  within 1e-5 scale-normalised (max |port - jax| / max |jax|) and aux
  within 1e-6. f32 reassociation of the same products stays far below
  that at these widths.
- At capacity factor 16 nothing drops: the port's a2a equals the port's
  ``moe_block`` within 1e-4 and aux within 1e-5, the bounds of the
  reference's own equivalence test.
- On a one-rank mesh with no drops the a2a equals ``moe_block``, and
  without a sharding context it raises.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
DROP_TOL, DROP_AUX_TOL = 1e-5, 1e-6
EQ_TOL, EQ_AUX_TOL = 1e-4, 1e-5


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


JAX_SIDE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, numpy as np, jax, jax.numpy as jnp
    from repro.configs import ARCHS, reduced, RunConfig
    from repro.models.common import RngStream, split_params
    from repro.models.moe import init_moe, moe_block_a2a
    from repro.parallel.axes import ShardingRules, sharding_ctx
    from repro.parallel import sharding as shd

    out = sys.argv[1]
    cfg = dataclasses.replace(reduced(ARCHS["deepseek-moe-16b"]), capacity_factor=1.25)
    auto = (jax.sharding.AxisType.Auto,) * 2
    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=auto)
    values, _ = split_params(init_moe(RngStream(0), cfg, jnp.float32))
    x = np.random.default_rng(0).normal(size=(4, 64, cfg.d_model)).astype(np.float32)
    rules = ShardingRules(mesh, shd.activation_rules(mesh, RunConfig()))
    with mesh, sharding_ctx(rules):
        y, aux = jax.jit(lambda v, x: moe_block_a2a(v, x, cfg))(values, jnp.asarray(x))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(values)[0]}
    np.savez(out, x=x, y=np.asarray(y), aux=np.asarray(aux), **{"w/" + k: v for k, v in flat.items()})
    print("JAX OK")
""")

TORCH_SIDE = textwrap.dedent("""
    import dataclasses, os, sys
    import numpy as np, torch, torch.distributed as dist
    import torch.multiprocessing as mp

    def nested(flat):
        tree = {}
        for path, v in flat.items():
            *parents, name = path.split("/")
            node = tree
            for key in parents:
                node = node.setdefault(key, {})
            node[name] = torch.from_numpy(v)
        return tree

    def run(rank, world, shape, inp, out, port):
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port)
        dist.init_process_group("gloo", rank=rank, world_size=world)
        from repro_torch.configs import ARCHS, reduced, RunConfig
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.moe import moe_block, moe_block_a2a
        from repro_torch.parallel.axes import sharding_ctx
        from repro_torch.parallel.sharding import make_rules

        data = np.load(inp)
        p = nested({k[2:]: data[k] for k in data.files if k.startswith("w/")})
        x = torch.from_numpy(data["x"])
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        res = {}
        if world == 1:
            try:
                moe_block_a2a(p, x, reduced(ARCHS["deepseek-moe-16b"]))
            except RuntimeError as e:
                res["raised"] = np.array(str(e))
        for cf in (1.25, 16.0):
            cfg = dataclasses.replace(reduced(ARCHS["deepseek-moe-16b"]), capacity_factor=cf)
            drops = {}
            with sharding_ctx(make_rules(mesh, RunConfig())):
                y, aux = moe_block_a2a(p, x, cfg, drops=drops)
            ref, aux_ref = moe_block(p, x, cfg)
            counts = torch.tensor([drops[k] for k in (
                "pair_routed", "pair_dropped", "local_routed", "local_dropped")])
            dist.all_reduce(counts)  # every rank's counts
            res.update({f"y{cf}": y.numpy(), f"aux{cf}": aux.numpy(),
                        f"ref{cf}": ref.numpy(), f"aux_ref{cf}": aux_ref.numpy(),
                        f"drops{cf}": counts.numpy()})
        if rank == 0:
            np.savez(out, **res)
        dist.destroy_process_group()

    if __name__ == "__main__":
        rows, cols, inp, out, port = sys.argv[1:]
        shape = (int(rows), int(cols))
        world = shape[0] * shape[1]
        mp.spawn(run, args=(world, shape, inp, out, port), nprocs=world)
        print("TORCH OK")
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("a2a") / "jax.npz"
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE, str(path)], capture_output=True,
                          text=True, env=_env(), cwd=ROOT, timeout=300)
    assert "JAX OK" in proc.stdout, proc.stderr[-3000:]
    return path


def _port(tmp_path, reference, shape):
    script = tmp_path / "torch_side.py"
    script.write_text(TORCH_SIDE)
    out = tmp_path / "port.npz"
    proc = subprocess.run(
        [sys.executable, str(script), *map(str, shape), str(reference), str(out),
         str(_free_port())],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert "TORCH OK" in proc.stdout, proc.stderr[-3000:]
    return np.load(out)


def _err(port, ref) -> float:
    return float(np.max(np.abs(port - ref)) / np.max(np.abs(ref)))


def test_a2a_on_8_gloo_ranks_matches_jax_a2a_and_moe_block(tmp_path, reference):
    ref = np.load(reference)
    port = _port(tmp_path, reference, (2, 4))
    # capacity 1.25: the two-stage drops decide the output; held to the JAX a2a
    pair_routed, pair_dropped, local_routed, local_dropped = port["drops1.25"]
    assert pair_dropped + local_dropped > 0, port["drops1.25"]
    drop_err = _err(port["y1.25"], ref["y"])
    print(f"8 ranks, capacity 1.25: err vs JAX a2a {drop_err:.3e}, aux "
          f"{abs(float(port['aux1.25']) - float(ref['aux'])):.3e}, moe_block vs JAX a2a "
          f"{_err(port['ref1.25'], ref['y']):.3e}, drops "
          f"{pair_dropped}/{pair_routed} (pair), {local_dropped}/{local_routed} (local)")
    assert drop_err <= DROP_TOL
    assert abs(float(port["aux1.25"]) - float(ref["aux"])) <= DROP_AUX_TOL
    # the drops matter at 1.25: the gspmd block differs there
    assert _err(port["ref1.25"], ref["y"]) > 100 * DROP_TOL
    # capacity 16: nothing drops; held to the port's moe_block
    assert port["drops16.0"][1] == 0 and port["drops16.0"][3] == 0
    assert _err(port["y16.0"], port["ref16.0"]) < EQ_TOL
    assert abs(float(port["aux16.0"]) - float(port["aux_ref16.0"])) < EQ_AUX_TOL


def test_a2a_on_one_rank_equals_moe_block_and_raises_without_a_context(tmp_path, reference):
    port = _port(tmp_path, reference, (1, 1))
    assert "sharding ctx" in str(port["raised"])
    assert port["drops16.0"][1] == 0 and port["drops16.0"][3] == 0
    assert _err(port["y16.0"], port["ref16.0"]) < EQ_TOL
    assert abs(float(port["aux16.0"]) - float(port["aux_ref16.0"])) < EQ_AUX_TOL
