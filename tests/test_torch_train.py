"""The port's train step, optimizer and checkpoints against the JAX package.

Reduced tinyllama in float32, the same weights (bridged) and the same
numpy batches on both sides. Tolerances:

* loss, grad_norm and parameters: scale-normalised max error <= 1e-5;
* the parameter *updates* (new - old), normalised by the largest update:
  at most 0.1% of the entries may differ by more than 1e-3, and none by
  more than 0.1. Early AdamW steps compute m / (sqrt(v) + 1e-8), which
  turns the f32 rounding of gradient entries near 1e-8 into visible
  changes of single entries (measured: <= 0.03% of entries, <= 2.5%).
  A wrong learning rate, bias correction or weight decay moves every
  entry by far more and fails both bounds.

Checkpoints must cross bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import RunConfig, get_config, reduced
from repro.models.common import split_params
from repro.models.transformer import build_model as jbuild
from repro.optim.optimizers import make_optimizer as jmake_optimizer
from repro.train.train_step import build_train_step as jbuild_train_step
from repro_torch.checkpoint import ckpt
from repro_torch.models.common import flatten_tree
from repro_torch.models.convert import load_values, to_numpy
from repro_torch.models.transformer import build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.train_step import build_train_step, fresh_train_state

pytestmark = pytest.mark.torch_port

TOL = 1e-5
DELTA_ENTRY_TOL, DELTA_FRAC, DELTA_MAX = 1e-3, 1e-3, 0.1


def err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def assert_updates_match(got, want, key):
    scale = np.max(np.abs(want)) + 1e-30
    rel = np.abs(np.asarray(got, np.float64) - want) / scale
    assert rel.max() <= DELTA_MAX, (key, rel.max())
    assert np.mean(rel > DELTA_ENTRY_TOL) <= DELTA_FRAC, (key, np.mean(rel > DELTA_ENTRY_TOL))


def _cfg(dtype="float32"):
    return dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                               param_dtype=dtype, compute_dtype=dtype)


def _batches(cfg, n, b=4, s=32, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tokens = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
        mask = (rng.random((b, s)) < 0.8).astype(np.float32)
        out.append({"tokens": tokens[:, :-1], "targets": tokens[:, 1:], "loss_mask": mask})
    return out


def _values(cfg, seed=0, norm_low=-0.2, norm_high=0.2):
    """JAX-initialised weights as numpy, with non-zero norm scales (init
    leaves them at 0, where a relative error means nothing)."""
    values, _ = split_params(jbuild(cfg).init(seed))
    values = jax.tree.map(np.asarray, values)
    rng = np.random.default_rng(seed + 1)
    seg = values["segments"][0]
    for name in ("ln1", "ln2"):
        seg[name] = rng.uniform(norm_low, norm_high, seg[name].shape).astype(np.float32)
    values["final_norm"] = rng.uniform(
        norm_low, norm_high, values["final_norm"].shape).astype(np.float32)
    return values


def _pair(cfg, run, values):
    """(jax state, jitted jax step, port state, port step) from one set of weights."""
    jmodel = jbuild(cfg)
    jopt = jmake_optimizer(run)
    jvalues = jax.tree.map(jnp.asarray, values)
    jstate = {"values": jvalues, "opt": jopt.init(jvalues), "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(jbuild_train_step(jmodel, run, jopt))
    model = build_model(cfg, device="cpu")
    load_values(model, values)
    opt = make_optimizer(run)
    state = fresh_train_state(model, opt)
    return jstate, jstep, state, build_train_step(model, run, opt)


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _flat_jax(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = np.asarray(leaf)
    return out


def _run_both(cfg, run, n_steps, values):
    jstate, jstep, state, step = _pair(cfg, run, values)
    before = {k: to_numpy(v) for k, v in flatten_tree(state["values"]).items()}
    for i, b in enumerate(_batches(cfg, n_steps)):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, _torch_batch(b))
        assert err(float(m["loss"]), float(jm["loss"])) <= TOL, i
        assert err(float(m["grad_norm"]), float(jm["grad_norm"])) <= TOL, i
    assert int(state["step"]) == int(jstate["step"]) == n_steps
    return before, _flat_jax(jstate["values"]), {
        k: to_numpy(v) for k, v in flatten_tree(state["values"]).items()}


@pytest.mark.parametrize("microbatch,grad_dtype", [(0, ""), (2, ""), (2, "bfloat16")])
def test_three_steps_match_jax(microbatch, grad_dtype):
    cfg = _cfg()
    run = RunConfig(microbatch=microbatch, grad_allreduce_dtype=grad_dtype)
    before, want, got = _run_both(cfg, run, 3, _values(cfg))
    assert want.keys() == got.keys()
    for k in want:
        assert err(got[k], want[k]) <= TOL, k
        assert_updates_match(got[k] - before[k], want[k] - before[k], k)


def _hybrid_values(cfg, low=-0.2, high=0.2):
    """JAX-initialised zamba2 weights as numpy, with the leaves that init
    leaves at 0 (norm scales, conv and dt biases) drawn non-zero."""
    values, _ = split_params(jbuild(cfg).init(0))
    values = jax.tree.map(np.asarray, values)
    rng = np.random.default_rng(1)
    for seg in values["segments"]:
        if seg:  # a Mamba-2 segment; the shared sites are {}
            for leaf in (seg, "ln"), (seg["mixer"], "conv_b"), (seg["mixer"], "dt_bias"):
                tree, name = leaf
                tree[name] = rng.uniform(low, high, tree[name].shape).astype(np.float32)
    return values


def test_hybrid_steps_match_jax():
    """Reduced zamba2 trains like the reference: the Mamba-2 blocks through
    the plain chunked scan (autograd, per-layer remat), the shared block's
    gradient summed over its two sites. Loss, grad_norm and parameters
    within TOL at every step; the gradients themselves are held leaf by
    leaf below. (The update check of the dense test does not transfer: a
    (2, 288) ``conv_b`` leaf is too small for its 0.1%-of-entries bound, and
    AdamW's third step turns f32 rounding into update differences of 1.6e-3
    of the largest update there.)"""
    cfg = reduced(get_config("zamba2-1.2b"))
    _, want, got = _run_both(cfg, RunConfig(), 3, _hybrid_values(cfg))
    assert want.keys() == got.keys() and "shared_attn/attn/wq" in got
    for k in want:
        assert err(got[k], want[k]) <= TOL, k


#: Gradient leaves of the hybrid, port against JAX, both in f32. Measured
#: against the port's float64 gradient, every leaf of either side is within
#: 2e-5; the widest is ``A_log`` (JAX 1.8e-5, the port 8e-6), whose
#: gradient sums decay terms of both signs over every (token, chunk pair),
#: so f32 cancellation shows there. A wrong mask, decay or routing gives
#: errors of order 1.
GRAD_TOL = 5e-5


def test_hybrid_gradients_match_jax():
    from repro.train.losses import lm_loss as jlm_loss
    from repro_torch.train.losses import lm_loss

    cfg = reduced(get_config("zamba2-1.2b"))
    values = _hybrid_values(cfg)
    batch = _batches(cfg, 1)[0]
    jmodel = jbuild(cfg)

    def jloss(v):
        logits, _, _ = jmodel.forward(v, {"tokens": jnp.asarray(batch["tokens"])})
        return jlm_loss(logits, jnp.asarray(batch["targets"]), jnp.asarray(batch["loss_mask"]))[0]

    jgrads = _flat_jax(jax.grad(jloss)(jax.tree.map(jnp.asarray, values)))
    model = build_model(cfg, device="cpu")
    load_values(model, values)
    tb = _torch_batch(batch)
    logits, _ = model({"tokens": tb["tokens"]}, remat="dots")
    params = flatten_tree(model.values())
    grads = torch.autograd.grad(lm_loss(logits, tb["targets"], tb["loss_mask"])[0],
                                list(params.values()))
    assert jgrads.keys() == params.keys()
    for k, g in zip(params, grads):
        assert err(g.numpy(), jgrads[k]) <= GRAD_TOL, k


def test_hybrid_weight_decay_by_rank_matches_jax():
    """The stacked per-head and per-channel Mamba-2 leaves (``A_log``,
    ``dt_bias``, ``D``, ``conv_b``) are rank 2, so AdamW decays them, as in
    the reference; a large learning rate makes the decay visible."""
    cfg = reduced(get_config("zamba2-1.2b"))
    run = RunConfig(learning_rate=20.0, weight_decay=0.5)  # lr at step 0: 0.1
    before, want, got = _run_both(cfg, run, 1, _hybrid_values(cfg, 0.5, 1.5))
    for name in ("ln", "mixer/A_log", "mixer/dt_bias", "mixer/D", "mixer/conv_b"):
        k = f"segments/0/{name}"
        assert got[k].ndim == 2, k
        assert_updates_match(got[k] - before[k], want[k] - before[k], k)


def _family_values(cfg, seed=0):
    """JAX-initialised weights as numpy with the leaves that init leaves at
    0 (or 1) drawn non-zero: norm scales, and the sLSTM's ``r_*`` and
    ``b_*``. A leaf at 0 with a gradient at f32 rounding level (the sLSTM's
    input gate behind its stabiliser) moves by +-lr on AdamW's first step
    in either package, so only its size can be compared."""
    values = jax.tree.map(np.asarray, split_params(jbuild(cfg).init(seed))[0])
    rng = np.random.default_rng(seed + 1)

    def walk(tree):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                walk(leaf)
            elif name.startswith(("ln", "out_norm")):
                tree[name] = rng.uniform(-0.2, 0.2, leaf.shape).astype(np.float32)
            elif name.startswith("r_"):
                tree[name] = (rng.normal(size=leaf.shape) / leaf.shape[-1] ** 0.5).astype(
                    np.float32)
            elif name.startswith("b_") and leaf.ndim == 2:  # the xLSTM gate biases
                tree[name] = rng.uniform(-1.0, 1.0, leaf.shape).astype(np.float32)

    for seg in values["segments"]:
        walk(seg)
    return values


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "xlstm-350m"])
def test_family_step_matches_jax(arch):
    """One AdamW step on reduced deepseek-moe-16b (the router aux, weighted
    by ``router_aux_weight``, in the loss; S = 32 at capacity factor 1.25
    drops assignments, so the gradient flows through the drop path too) and
    reduced xlstm-350m (the mLSTM's chunked form and the sLSTM's loop under
    autograd, with per-layer remat): loss, grad_norm, aux and every
    parameter within TOL of the reference's."""
    cfg = reduced(get_config(arch))
    jstate, jstep, state, step = _pair(cfg, RunConfig(), _family_values(cfg))
    (b,) = _batches(cfg, 1)
    jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
    state, m = step(state, _torch_batch(b))
    for k in ("loss", "grad_norm", "aux"):
        assert err(float(m[k]), float(jm[k])) <= TOL, k
    assert (float(m["aux"]) > 0) == bool(cfg.moe_num_experts)
    want = _flat_jax(jstate["values"])
    got = {k: to_numpy(v) for k, v in flatten_tree(state["values"]).items()}
    assert want.keys() == got.keys()
    for k in want:
        assert err(got[k], want[k]) <= TOL, k


def test_weight_decay_by_rank_matches_jax():
    """AdamW decays every rank >= 2 leaf: the stacked (L, d) norm scales
    are decayed, final_norm (d,) is not. A large learning rate and non-zero
    norm scales make a missing or extra decay visible in one step."""
    cfg = _cfg()
    values = _values(cfg, norm_low=0.5, norm_high=1.5)
    run = RunConfig(learning_rate=20.0, weight_decay=0.5)  # lr at step 0: 0.1
    before, want, got = _run_both(cfg, run, 1, values=values)
    for k in ("segments/0/ln1", "segments/0/ln2", "final_norm"):
        assert_updates_match(got[k] - before[k], want[k] - before[k], k)


def test_zero_gradient_update_is_pure_decay_on_rank_two():
    cfg = _cfg()
    model = build_model(cfg, device="cpu").init(0)
    with torch.no_grad():
        for p in (model.segments[0].ln1, model.final_norm):
            p.fill_(1.0)
    run = RunConfig(learning_rate=20.0, weight_decay=0.5)
    opt = make_optimizer(run)
    params = flatten_tree(model.values())
    state = opt.init(params)
    opt.update({k: torch.zeros_like(v) for k, v in params.items()}, state, params,
               torch.zeros((), dtype=torch.int32))
    lr0 = 20.0 * 1 / 200
    assert torch.allclose(model.segments[0].ln1, torch.full_like(model.final_norm, 1 - lr0 * 0.5))
    assert torch.equal(model.final_norm, torch.ones_like(model.final_norm))


def _jax_state(cfg, seed):
    jmodel = jbuild(cfg)
    jopt = jmake_optimizer(RunConfig())
    values, _ = split_params(jmodel.init(seed))
    return {"values": values, "opt": jopt.init(values), "step": jnp.asarray(7, jnp.int32)}


def _bits(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16 or a.dtype.kind == "V":
        return a.view(np.uint16)
    return a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_into_port(tmp_path, dtype):
    cfg = _cfg(dtype)
    jstate = _jax_state(cfg, seed=2)
    jckpt.save_checkpoint(tmp_path, 7, jstate)
    model = build_model(cfg, device="cpu").init(9)
    state = fresh_train_state(model, make_optimizer(RunConfig()))
    ckpt.restore_checkpoint(tmp_path, 7, state)
    want = _flat_jax(jstate)
    got = {k: to_numpy(v) for k, v in flatten_tree(state).items()}
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_into_jax(tmp_path, dtype):
    cfg = _cfg(dtype)
    model = build_model(cfg, device="cpu").init(4)
    state = fresh_train_state(model, make_optimizer(RunConfig()))
    state["step"] += 11
    ckpt.save_checkpoint(tmp_path, 11, state)
    assert ckpt.latest_step(tmp_path) == 11
    restored = jckpt.restore_checkpoint(tmp_path, 11, _jax_state(cfg, seed=0))
    want = {k: to_numpy(v) for k, v in flatten_tree(state).items()}
    got = _flat_jax(restored)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)


def test_async_checkpointer_keeps_newest(tmp_path):
    model = build_model(_cfg(), device="cpu").init(0)
    state = fresh_train_state(model, make_optimizer(RunConfig()))
    saver = ckpt.AsyncCheckpointer(tmp_path, keep=2)
    for s in (1, 2, 3):
        saver.save(s, state)
    saver.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002", "step_00000003"]
    assert not list(tmp_path.glob(".tmp_*"))


def test_launcher_parser_spells_every_reference_flag():
    from repro.launch.train import build_parser as ref_parser
    from repro_torch.launch.train import build_parser

    def flags(ap):
        return {(s, a.dest, a.default, tuple(a.choices or ()), a.nargs, a.const)
                for a in ap._actions for s in a.option_strings}

    mine, ref = flags(build_parser()), flags(ref_parser())
    assert ref <= mine
    assert {f[0] for f in mine - ref} == {"--device"}


def test_launcher_trains_on_cpu_through_the_gather_path(tmp_path, capsys):
    from repro_torch.launch.train import parse_args, train

    args = parse_args(["--arch", "tinyllama-1.1b", "--device", "cpu", "--steps", "3",
                       "--device-path", "gather", "--num-docs", "64", "--seq-len", "32",
                       "--batch", "4", "--ckpt-every", "2", "--workdir", str(tmp_path)])
    seen = []
    summary = train(args, on_batch=lambda step, feed: seen.append(step))
    assert seen == [0, 1, 2] and summary["steps"] == 3
    assert all(np.isfinite(summary["losses"]))
    assert summary["device_stats"].kernel_steps >= 3
    assert ckpt.latest_step(tmp_path / "ckpt") == 2
    assert "done: 3 steps" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "xlstm-350m"])
def test_launcher_trains_each_family_on_cpu(arch, tmp_path, capsys):
    """The MoE and xLSTM families train through the launcher at reduced
    size, the batches assembled by the gather path."""
    from repro_torch.launch.train import parse_args, train

    args = parse_args(["--arch", arch, "--device", "cpu", "--steps", "2", "--device-path",
                       "gather", "--num-docs", "64", "--seq-len", "32", "--batch", "4",
                       "--workdir", str(tmp_path)])
    summary = train(args)
    assert summary["steps"] == 2 and all(np.isfinite(summary["losses"]))
    assert "done: 2 steps" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--device-path", "gather"], ["--resume-data", "d"],
                                  ["--suspend-after", "2"]])
def test_launcher_rejects_what_the_reference_rejects(flag, capsys):
    """With --data-server, the flags that need a local data plane are usage
    errors, as in the reference's launcher."""
    from repro_torch.launch.train import parse_args

    with pytest.raises(SystemExit) as e:
        parse_args(["--arch", "tinyllama-1.1b", "--device", "cpu", "--data-server", "x.sock",
                    *flag])
    assert e.value.code == 2
    assert flag[0] in capsys.readouterr().err


@pytest.mark.parametrize("flag", [["--data-server", "x.sock", "--device-path", "stage"],
                                  ["--autotune", "--device-path", "gather"]])
def test_launcher_service_paths_refuse_without_a_card(flag, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.launch.train import parse_args

    with pytest.raises(SystemExit) as e:
        parse_args(["--arch", "tinyllama-1.1b", *flag])
    assert e.value.code == 2
    assert "CUDA" in capsys.readouterr().err
