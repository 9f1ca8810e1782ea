"""The port's autotuner, baselines and failure tools against the reference's.

Both packages get the same fixed ``Calibration`` (``calibrate`` itself
times reads, so only its fields and ranges are checked) and must choose
equal ``TuneChoice``s and compute equal step I/O. The baseline loaders
must count the same ``NodeStats`` / ``StepIO`` on the same sequences, and
the straggler and heartbeat monitors must make the same decisions on the
same series. All comparisons are exact.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from test_torch_service import build_twins, timeless

import repro.autotune as ref_autotune
import repro.core as ref_core
import repro_torch.autotune as port_autotune
import repro_torch.core as port_core

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
SIDES = {"ref": (ref_autotune, ref_core), "port": (port_autotune, port_core)}
PROFILES = {  # backend: (bytes/s, chunk overhead s, file overhead s)
    "vfs": (180e6, 2.5e-4, 1.0e-4),
    "mmap": (950e6, 4.0e-5, 2.0e-5),
    "parallel": (420e6, 1.2e-4, 6.0e-5),
}


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    ref, port = build_twins(tmp_path_factory.mktemp("autotune"))
    return {"ref": ref, "port": port}


def calibration(autotune):
    return autotune.Calibration(
        backends={name: autotune.BackendProfile(name, bw, chunk, file, 24)
                  for name, (bw, chunk, file) in PROFILES.items()},
        decode_bytes_per_s=2.1e9, chunk_bytes_mean=3300.0)


def both(fn):
    """``fn(autotune, core)`` on each side, as plain values."""
    return [timeless(fn(*SIDES[side])) for side in ("ref", "port")]


@pytest.mark.parametrize("compute", [0.0, 1e-5, 1e-3])
@pytest.mark.parametrize("bands", [1, 4])
@pytest.mark.parametrize("memory", [None, 5_000])
def test_select_config_on_a_fixed_calibration(compute, bands, memory):
    def choose(autotune, core):
        demand = autotune.uniform_step_io(240_000, 48, 20)
        return autotune.select_config(calibration(autotune), demand, compute_per_step_s=compute,
                                      memory_limit_bytes=memory, bands=bands,
                                      readahead_grid=(1, 2, 4, 8))
    ref, port = both(choose)
    assert port == ref
    assert port["backend"] in PROFILES


def test_select_config_with_a_plan_and_claims(twins):
    """Demand from a real EpochPlan on each twin: plan_step_io, the claim
    schedule's required_cache_bytes, and the choice they feed."""
    out = {}
    for side, root in twins.items():
        autotune, core = SIDES[side]
        store = core.ChunkStore.open(root)
        cluster = core.Cluster(store.plan, 2, store=store, seed=2)
        plan = core.EpochPlanner(cluster).plan(core.EpochSampler(store.plan.num_files, 2, seed=4),
                                               0, 4)
        chunk_bytes = np.asarray(store.plan.chunk_bytes)
        step_io = autotune.plan_step_io(plan, chunk_bytes)
        claims = plan.load_chunk.tolist()
        need = autotune.required_cache_bytes(claims, chunk_bytes)
        choice = autotune.select_config(calibration(autotune), step_io, compute_per_step_s=1e-4,
                                        claims=claims, chunk_bytes=chunk_bytes,
                                        memory_limit_bytes=need // 2 + 1)
        fidelity = autotune.select_fidelity(choice.model, step_io, 1e-6, 5)
        out[side] = timeless((step_io, need, choice, fidelity))
        store.close()
    assert out["port"] == out["ref"]
    assert out["port"][1] > 0 and out["port"][2]["cache_limit_bytes"] == out["port"][1] // 2 + 1


def test_required_cache_bytes_and_uniform_demand():
    rng = np.random.default_rng(7)
    for _ in range(20):
        n = int(rng.integers(2, 12))
        claims = rng.integers(0, n, size=int(rng.integers(0, 60))).tolist()
        sizes = rng.integers(1, 1000, size=n)
        assert (port_autotune.required_cache_bytes(claims, sizes)
                == ref_autotune.required_cache_bytes(claims, sizes))
        total, steps = int(rng.integers(1, 10**6)), int(rng.integers(0, 40))
        ref, port = both(lambda a, c: a.uniform_step_io(total, n, steps))
        assert port == ref


def test_calibrate_fields_and_ranges(twins):
    calib = port_autotune.calibrate(twins["port"], sample_chunks=8, repeats=1)
    assert set(calib.backends) == set(PROFILES)
    for name, p in calib.backends.items():
        assert p.backend == name and p.samples == 8
        assert p.bandwidth_bytes_per_s > 0
        assert p.chunk_overhead_s >= 0 and p.file_overhead_s >= 0
    assert calib.decode_bytes_per_s > 0
    store = port_core.ChunkStore.open(twins["port"])
    assert calib.chunk_bytes_mean == float(np.asarray(store.plan.chunk_bytes).mean())
    store.close()


def test_cli_saves_a_calibration_the_reference_loads(twins, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.autotune", str(twins["port"]),
                          "--save", str(tmp_path / "f.json"), "--compute-per-step", "1e-4"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "selected: backend=" in out.stdout
    ref = ref_autotune.Calibration.load(tmp_path / "f.json")
    port = port_autotune.Calibration.load(tmp_path / "f.json")
    assert ref.to_dict() == port.to_dict() == json.loads((tmp_path / "f.json").read_text())
    assert set(ref.backends) == set(PROFILES)


# ------------------------------------------------------------ baselines
@pytest.mark.parametrize("name", ["PyTorchStyleLoader", "CoorDLLoader", "NoIOLoader"])
def test_baseline_epoch_matches_reference(name):
    def run(_, core):
        sizes = np.random.default_rng(3).integers(500, 1500, size=600).astype(np.int64)
        plan = core.ChunkingPlan.create(sizes, 8, num_slots=32, seed=1)
        sampler = core.EpochSampler(600, 2, seed=2)
        mem = int(sizes.sum() * 0.3 / 2)
        args = {"PyTorchStyleLoader": (plan, 2, mem), "CoorDLLoader": (plan, 2, mem, 5),
                "NoIOLoader": (plan, 2)}[name]
        return [core.run_baseline_epoch(getattr(core, name)(*args), sampler, e, 16)
                for e in range(2)]
    ref, port = both(run)
    assert port == ref
    assert port[0][0]["accesses"] == 600


# ------------------------------------------------------- failure tools
def failures(side):
    return importlib.import_module(f"{'repro' if side == 'ref' else 'repro_torch'}.ft.failures")


def test_straggler_monitor_decides_as_reference():
    rng = np.random.default_rng(11)
    for workers in (1, 2, 3, 5):
        series = [(int(w), float(t)) for w, t in zip(rng.integers(0, workers, 200),
                                                     rng.gamma(2.0, 0.05, 200))]
        slow = int(rng.integers(0, workers))
        series += [(slow, 0.9)] * 6
        decisions = {}
        for side in ("ref", "port"):
            mon = failures(side).StragglerMonitor(workers, window=8, threshold=2.0)
            got = [mon.stragglers()]
            for w, t in series:
                mon.record(w, t)
                got.append(mon.stragglers())
            decisions[side] = got
        assert decisions["port"] == decisions["ref"]
        if workers > 1:
            assert slow in decisions["port"][-1]


def test_heartbeat_and_failure_injector_decide_as_reference(monkeypatch):
    """Both monitors on one scripted clock: the same workers go dead."""
    clock = [100.0]
    decisions = {}
    for side in ("ref", "port"):
        mod = failures(side)
        monkeypatch.setattr(mod.time, "monotonic", lambda: clock[0])
        clock[0] = 100.0
        hb = mod.Heartbeat(4, timeout_s=5.0)
        got = []
        for t, pings in ((102.0, [0, 1]), (104.0, [0]), (106.5, [0, 2]), (110.0, [2])):
            clock[0] = t
            for w in pings:
                hb.ping(w)
            got.append(hb.dead_workers())
        hb.mark_dead(2)
        got.append(hb.dead_workers())
        inj = mod.FailureInjector({3: 1, 7: 0})
        got.append([inj.maybe_fail(s) for s in range(9)])
        decisions[side] = got
    assert decisions["port"] == decisions["ref"]
    assert decisions["port"][2] == [3] and decisions["port"][4] == [1, 2, 3]


def test_ft_is_a_namespace_package_as_in_the_reference():
    assert not (ROOT / "src" / "repro" / "ft" / "__init__.py").exists()
    assert not (ROOT / "src" / "repro_torch" / "ft" / "__init__.py").exists()
    assert dataclasses.is_dataclass(failures("port").FailureInjector)


# ------------------------------------------------------------ the trainer
def test_trainer_autotunes_and_gathers_on_cpu(tmp_path, capsys):
    from repro_torch.core.storage import make_backend
    from repro_torch.launch.train import parse_args, train

    args = parse_args(["--arch", "tinyllama-1.1b", "--device", "cpu", "--steps", "3",
                       "--autotune", "--device-path", "gather", "--num-docs", "64",
                       "--seq-len", "32", "--batch", "4", "--workdir", str(tmp_path)])
    seen = []
    summary = train(args, on_batch=lambda step, feed: seen.append(
        {k: v.numpy().copy() for k, v in feed.items()}))
    out = capsys.readouterr().out
    choice = summary["autotune"]
    assert f"autotune: {choice.describe()}" in out and "done: 3 steps" in out
    assert choice.backend in PROFILES
    assert summary["device_stats"].kernel_steps == summary["device_stats"].steps >= 3
    kw = {"readahead": choice.readahead} if choice.readahead else {}
    store = port_core.ChunkStore.open(tmp_path / "chunks",
                                      backend=make_backend(choice.backend, **kw))
    host = port_core.RedoxLoader.from_spec(summary["spec"], store).epoch(0)
    for feed, want in zip(seen, host):
        for k in feed:
            np.testing.assert_array_equal(feed[k], want[k])
    store.close()
    assert len(seen) == 3 and all(np.isfinite(summary["losses"]))
