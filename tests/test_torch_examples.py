"""The torch twins of the JAX examples, and phase 15's batch streams,
against the JAX package on the CPU.

* ``examples/serve_decode_torch.py``: ``generate`` on weights moved from the
  JAX example's ``model.init(0)`` gives the JAX example's greedy ids (f32,
  reduced tinyllama and zamba2); the twin's own command prints the
  example's three lines.
* ``examples/train_lm_torch.py``: resumed from a checkpoint that the JAX
  example wrote, it ends 6 steps later at the JAX example's weights within
  ``TOL`` (scale-normalised, f32), with the same data-plane stats line.
* ``chip_smoke.py``'s convergence streams equal ``benchmarks/
  convergence.py``'s byte for byte over 2 epochs (the Redox one staged
  through the port's gather), and the port's train step gives the JAX
  step's losses on the first Redox batches from one converted init.
* the smoke's hold of every staged batch of phases 14 and 15 to the host
  stream of a fresh loader on the same store, and that it fails on one
  wrong token.

The JAX scripts are loaded from their files and run in this process; none
of them is edited.
"""

import dataclasses
import importlib.util
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, get_config, reduced
from repro.models import build_model as jbuild
from repro.models import split_params
from repro.optim.optimizers import make_optimizer as jmake_optimizer
from repro.train.train_step import build_decode_step as jbuild_decode_step
from repro.train.train_step import build_prefill_step as jbuild_prefill_step
from repro.train.train_step import build_train_step as jbuild_train_step
from repro_torch.core.device import DeviceStager
from repro_torch.models.convert import load_values
from repro_torch.models.transformer import build_model

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
#: Scale-normalised max error in f32, as ``tests/test_torch_train.py``'s.
TOL = 1e-5
STREAM_KEYS = ("tokens", "targets", "loss_mask")


def _load(rel: str):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(f"_loaded_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def serve_twin():
    return _load("examples/serve_decode_torch.py")


@pytest.fixture(scope="module")
def smoke():
    return _load("chip_smoke.py")


@pytest.fixture(scope="module")
def convergence():
    return _load("benchmarks/convergence.py")


def err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


# ------------------------------------------------------------------ serving
def _jax_generate(model, values, prompts, new_tokens, max_len):
    """``examples/serve_decode.py``'s loop: jitted prefill, then the jitted
    decode with the cache donated, a fresh int32 position each step."""
    prefill = jax.jit(jbuild_prefill_step(model, max_len=max_len))
    decode = jax.jit(jbuild_decode_step(model), donate_argnums=1)
    logits, cache = prefill(values, {"tokens": jnp.asarray(prompts, jnp.int32)})
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    out = [tok]
    for t in range(new_tokens - 1):
        logits, cache = decode(values, cache, tok, jnp.int32(prompts.shape[1] + t))
        tok = jnp.argmax(logits[:, 0], axis=-1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-1.2b"])
def test_serve_twin_generates_the_jax_examples_ids(arch, serve_twin):
    batch, prompt_len, new_tokens = 2, 16, 6
    cfg = reduced(get_config(arch))
    jmodel = jbuild(cfg)
    values, _ = split_params(jmodel.init(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, prompt_len))
    max_len = prompt_len + new_tokens
    want = _jax_generate(jmodel, values, prompts, new_tokens, max_len)

    model = build_model(cfg, device="cpu")
    load_values(model, jax.tree.map(np.asarray, values))
    timings = {}
    got = serve_twin.generate(model, torch.from_numpy(prompts.astype(np.int32)), new_tokens,
                              max_len, timings)
    assert got.dtype == torch.int32 and got.shape == (batch, new_tokens)
    np.testing.assert_array_equal(got.numpy(), want)
    assert timings["captured"] is False  # the CPU decodes eagerly


def test_serve_twin_prints_the_examples_lines(serve_twin):
    argv = ["--arch", "tinyllama-1.1b", "--batch", "2", "--prompt-len", "16",
            "--new-tokens", "6", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "examples/serve_decode_torch.py", *argv],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 3, lines
    assert re.fullmatch(r"prefill: 2 prompts x 16 tokens in \d+\.\d\ds", lines[0])
    assert re.fullmatch(r"decoded 6 tokens/seq in \d+\.\d\ds \(\d+\.\d tok/s on CPU\)",
                        lines[1])
    cfg = reduced(get_config("tinyllama-1.1b"))
    model = build_model(cfg, device="cpu").init(0)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    ids = serve_twin.generate(model, torch.from_numpy(prompts), 6, 22)
    assert lines[2] == f"generated token ids (first sequence): {ids[0].tolist()}"


# ----------------------------------------------------------------- training
def _run_main(module_path: str, argv, monkeypatch, capsys) -> str:
    """Run an example's ``main`` in this process with ``argv`` as its
    command line; return what it printed."""
    module = _load(module_path)
    monkeypatch.setattr(sys, "argv", [module_path, *argv])
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out


def _stats_line(out: str) -> str:
    (line,) = [ln for ln in out.splitlines() if ln.startswith("done: ")]
    return line


def test_train_twin_resumes_a_jax_checkpoint_to_the_jax_weights(tmp_path, monkeypatch, capsys):
    a, b = tmp_path / "jax", tmp_path / "torch"
    common = ["--preset", "small", "--ckpt-every", "6"]
    _run_main("examples/train_lm.py", common + ["--steps", "6", "--workdir", str(a)],
              monkeypatch, capsys)
    shutil.copytree(a, b)
    ref = _run_main("examples/train_lm.py", common + ["--steps", "12", "--workdir", str(a)],
                    monkeypatch, capsys)
    got = _run_main("examples/train_lm_torch.py",
                    common + ["--steps", "12", "--workdir", str(b), "--device", "cpu"],
                    monkeypatch, capsys)
    for out in (ref, got):
        assert "resumed from step 6" in out and "done: 12 steps" in out
    assert _stats_line(got) == _stats_line(ref)
    assert re.search(r"^throughput: [\d,]+ tokens/sec over 6 step\(s\)$", got, re.MULTILINE)

    with np.load(a / "ckpt" / "step_00000012" / "state.npz") as z:
        want = {k: z[k] for k in z.files}
    with np.load(b / "ckpt" / "step_00000012" / "state.npz") as z:
        mine = {k: z[k] for k in z.files}
    assert want.keys() == mine.keys()
    assert int(want["step"]) == int(mine["step"]) == 12
    weights = [k for k in want if k.startswith("values/")]
    assert len(weights) >= 10
    for k in weights:
        assert mine[k].dtype == np.float32 and mine[k].shape == want[k].shape, k
        assert err(mine[k], want[k]) <= TOL, (k, err(mine[k], want[k]))


# -------------------------------------------------------- convergence streams
def _assert_streams_equal(got, want):
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        for k in STREAM_KEYS:
            v = g[k].numpy() if isinstance(g[k], torch.Tensor) else g[k]
            assert v.dtype == w[k].dtype and v.shape == w[k].shape, (i, k)
            np.testing.assert_array_equal(v, w[k], err_msg=f"batch {i} {k}")


@pytest.mark.parametrize("slots", [96, 32])
def test_redox_stream_equals_the_benchmarks(slots, tmp_path, smoke, convergence):
    want = list(convergence._redox_batches(tmp_path / "jax", 2, memory_slots=slots))
    stager = DeviceStager(device="cpu")
    got = list(smoke.redox_batches(tmp_path / "torch", 2, slots, stager))
    stager.close()
    assert len(want) == 2 * (smoke.CONV_DOCS // smoke.CONV_BATCH)
    assert stager.stats.kernel_steps == len(got)  # staged through the gather
    _assert_streams_equal(got, want)


def test_exact_shuffle_stream_equals_the_benchmarks(smoke, convergence):
    _assert_streams_equal(list(smoke.exact_shuffle_batches(2)),
                          list(convergence._exact_shuffle_batches(2)))
    other = next(smoke.exact_shuffle_batches(1, smoke.CONV_YARDSTICK_SEED))
    assert not np.array_equal(other["tokens"], next(smoke.exact_shuffle_batches(1))["tokens"])


def test_convergence_losses_match_the_jax_step(tmp_path, smoke):
    steps, lr = 8, 3e-3
    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                              vocab_size=smoke.CONV_VOCAB, num_layers=2)
    stager = DeviceStager(device="cpu")
    batches = smoke.redox_batches(tmp_path, 1, smoke.CONV_SLOTS, stager)
    feed = [{k: b[k].numpy().copy() for k in STREAM_KEYS} for _, b in zip(range(steps), batches)]
    batches.close()
    stager.close()

    jmodel = jbuild(cfg)
    run = RunConfig(optimizer="adamw", learning_rate=lr)
    jopt = jmake_optimizer(run)
    values, _ = split_params(jmodel.init(smoke.CONV_INIT_SEED))
    jstate = {"values": values, "opt": jopt.init(values), "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(jbuild_train_step(jmodel, run, jopt))
    want = []
    for b in feed:
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray, b))
        want.append(float(m["loss"]))

    model = build_model(cfg, device="cpu")
    load_values(model, jax.tree.map(np.asarray, values))
    got = smoke.convergence_losses(model, lr, iter(feed), steps)
    assert len(got) == steps
    for i, (g, w) in enumerate(zip(got, want)):
        assert err(g, w) <= TOL, (i, g, w)


# ------------------------------------------- the smoke's host-stream checks
def _feeds(batches):
    return [{k: torch.as_tensor(b[k]).clone() for k in STREAM_KEYS} for b in batches]


@pytest.mark.parametrize("slots", [96, 32])
def test_staged_redox_stream_is_held_to_the_host_stream(slots, tmp_path, smoke, capsys):
    """Phase 15's check: the batches staged through ``epoch_device`` equal
    the host stream of a fresh loader on the reopened store, and one wrong
    target or a short host stream fails it."""
    stager = DeviceStager(device="cpu")
    fed = _feeds(smoke.redox_batches(tmp_path, 2, slots, stager))
    stager.close()
    assert len(fed) == 2 * (smoke.CONV_DOCS // smoke.CONV_BATCH)
    smoke.hold_to_host_stream("redox", fed, smoke.redox_host_batches(tmp_path, 2, slots))
    assert f"redox: staged batches equal the host stream ({len(fed)} steps)" in (
        capsys.readouterr().out)

    fed[70]["targets"][3, 5] += 1
    with pytest.raises(SystemExit):
        smoke.hold_to_host_stream("redox", fed, smoke.redox_host_batches(tmp_path, 2, slots))
    fed[70]["targets"][3, 5] -= 1
    with pytest.raises(SystemExit):
        smoke.hold_to_host_stream("redox", fed, smoke.redox_host_batches(tmp_path, 1, slots))


def test_convergence_losses_show_every_feed(smoke):
    """``convergence_losses`` hands each feed to ``on_batch`` before its step."""
    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                              vocab_size=smoke.CONV_VOCAB, num_layers=1)
    batches = list(zip(range(3), smoke.exact_shuffle_batches(1)))
    seen = []
    model = build_model(cfg, device="cpu").init(smoke.CONV_INIT_SEED)
    losses = smoke.convergence_losses(model, 3e-3, (b for _, b in batches), 3,
                                      on_batch=lambda i, feed: seen.append((i, feed)))
    assert len(losses) == 3 and [i for i, _ in seen] == [0, 1, 2]
    for (_, feed), (_, b) in zip(seen, batches):
        for k in STREAM_KEYS:
            np.testing.assert_array_equal(feed[k].numpy(), b[k])


def test_train_twin_feeds_the_host_stream_and_reuses_its_store(tmp_path, smoke, monkeypatch,
                                                               capsys):
    """Phase 14's check on the CPU: the twin's staged batches (the gather's
    plain version here) equal the host stream of a fresh loader on its
    store, in the first run and in the resumed one, which reuses that
    store instead of building another."""
    twin = _load("examples/train_lm_torch.py")
    argv = ["--preset", "small", "--device", "cpu", "--device-path", "gather",
            "--ckpt-every", "2", "--workdir", str(tmp_path)]
    store = None
    for steps in (2, 4):
        args = twin.parse_args(argv + ["--steps", str(steps)])
        fed = []
        summary = twin.train(args, on_batch=lambda step, feed: fed.append(feed), store=store)
        assert len(fed) == 2 and summary["device_stats"].kernel_steps >= 2
        store = summary["store"]
        _, loader = twin.build_loader(store, "small", args.nodes)
        smoke.hold_to_host_stream("twin", fed, loader.epoch(0))
        # The resumed run must not build a store.
        monkeypatch.setattr(twin.SyntheticTokenDataset, "build_store",
                            lambda *a, **k: pytest.fail("the store was built again"))
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "done: 4 steps" in out
    assert out.count("twin: staged batches equal the host stream (2 steps)") == 2
    fed[1]["tokens"][0, 0] += 1
    with pytest.raises(SystemExit):
        smoke.hold_to_host_stream("twin", fed, twin.build_loader(store, "small", 2)[1].epoch(0))
    store.close()
