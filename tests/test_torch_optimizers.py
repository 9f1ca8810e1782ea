"""The port's Adafactor and SGD-momentum against the JAX package's.

The same f32 values, gradients and steps on both sides, as numpy. A tree
is the port's flat ``{path: tensor}`` dict and the reference's nested one
over the same paths. Tolerance: scale-normalised max error (max |port -
jax| / max |jax|) <= 1e-5 on values and every state leaf; bf16 values
(Adafactor without its f32 master, the kimi-k2 recipe) may differ by one
bf16 rounding of the update.

The leaves cover the stacked tree's ranks: a (L, m, n) layer matrix, a
(L, d) norm stack, a (d,) vector and a (m, n) matrix. The layer matrix's
layers differ in scale (values and gradients) and in the shape of their
gradients: Adafactor's ``u`` is invariant to a gradient's scale, so what
sets a layer's RMS is how far its gradient is from the row-and-column
factored estimate. One layer's gradient is one large entry over small
noise, which that estimate misses by far (RMS 3.6e4), the others are
dense (RMS near 1). The RMS clip runs over the whole stacked leaf, so the
large layer scales the others down with it; a per-layer clip would not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import RunConfig, get_config, reduced
from repro.optim.optimizers import make_optimizer as jmake_optimizer
from repro_torch.checkpoint import ckpt
from repro_torch.models.common import flatten_tree
from repro_torch.models.convert import to_numpy
from repro_torch.models.transformer import build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.train_step import build_train_step, fresh_train_state

pytestmark = pytest.mark.torch_port

TOL = 1e-5
SHAPES = {"stack/w": (3, 12, 16), "stack/ln": (3, 16), "final_norm": (16,), "head": (16, 10)}
#: Scale of each layer of ``stack/w`` and its gradient.
LAYER_SCALES = np.array([1.0, 1e-3, 30.0], np.float32)[:, None, None]
#: (optimizer, master_fp32, dtype of the values)
CASES = {"adafactor": ("adafactor", True, "float32"),
         "adafactor-no-master": ("adafactor", False, "float32"),
         "adafactor-no-master-bf16": ("adafactor", False, "bfloat16"),
         "sgdm": ("sgdm", True, "float32")}


def err(got, want) -> float:
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    return float(np.max(np.abs(g - w)) / (np.max(np.abs(w)) + 1e-30))


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = leaf
    return out


def _draw(seed, zero=(), grad=False):
    """Values (``grad`` False) or a gradient: normal leaves, ``stack/w``'s
    layers scaled by LAYER_SCALES, and in a gradient its layer 1 one large
    entry over small noise; the leaves in ``zero`` all zero."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shape in SHAPES.items():
        x = rng.normal(size=shape).astype(np.float32)
        if path == "stack/w":
            x = x * LAYER_SCALES
            if grad:
                x[1] *= 1e-2
                x[1, 2, 3] = 5.0
        out[path] = np.zeros(shape, np.float32) if path in zero else x
    return out


def _jax_flat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = np.asarray(jnp.asarray(leaf, jnp.float32))
    return out


def _port_flat(tree) -> dict:
    return {k: v.float().numpy() for k, v in flatten_tree(tree).items()}


def _run_both(optimizer, master, dtype, steps=4, zero=(), **run_kw):
    """``steps`` updates from the same values and gradients on both sides;
    returns (port values, port state, jax values, jax state) as flat numpy."""
    run = RunConfig(optimizer=optimizer, master_fp32=master, **run_kw)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    values = _draw(0)
    jvalues = _nest({k: jnp.asarray(v, jdt) for k, v in values.items()})
    pvalues = {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in values.items()}
    jopt, opt = jmake_optimizer(run), make_optimizer(run)
    jstate, state = jopt.init(jvalues), opt.init(pvalues)
    for i in range(steps):
        grads = _draw(10 + i, zero, grad=True)
        jvalues, jstate = jopt.update(_nest({k: jnp.asarray(g) for k, g in grads.items()}),
                                      jstate, jvalues, jnp.asarray(i, jnp.int32))
        opt.update({k: torch.from_numpy(g) for k, g in grads.items()}, state, pvalues,
                   torch.tensor(i, dtype=torch.int32))
    return _port_flat(pvalues), _port_flat(state), _jax_flat(jvalues), _jax_flat(jstate)


@pytest.mark.parametrize("case", list(CASES))
def test_four_updates_match_jax(case):
    optimizer, master, dtype = CASES[case]
    got, got_state, want, want_state = _run_both(optimizer, master, dtype)
    assert got.keys() == want.keys() and got_state.keys() == want_state.keys()
    for k in want:
        if dtype == "bfloat16":  # one bf16 rounding of a value, at most
            np.testing.assert_allclose(got[k], want[k], rtol=2**-8, atol=0, err_msg=k)
        else:
            assert err(got[k], want[k]) <= TOL, k
    for k in want_state:
        assert err(got_state[k], want_state[k]) <= TOL, k
        assert np.isfinite(got_state[k]).all(), k


def test_adafactor_clips_the_whole_stacked_leaf():
    """The RMS clip of a (L, m, n) leaf is one mean over all its layers, as
    the reference's: the port matches it, and a per-layer clip (each
    layer's own rms) would not."""
    run = RunConfig(optimizer="adafactor", master_fp32=True)
    opt = make_optimizer(run)
    values = {k: torch.from_numpy(v) for k, v in _draw(0).items()}
    before = values["stack/w"].clone()
    state = opt.init(values)
    grads = _draw(10, grad=True)
    g = torch.from_numpy(grads["stack/w"])
    opt.update({k: torch.from_numpy(v) for k, v in grads.items()}, state, values,
               torch.tensor(0, dtype=torch.int32))
    # At step 0 beta = 0, so v is g² + eps itself; rebuild u per layer.
    g2 = g * g + 1e-30
    vr, vc = g2.mean(-1), g2.mean(-2)
    vhat = vr[..., None] / vr.mean(-1, keepdim=True)[..., None] * vc[..., None, :]
    u = g / torch.sqrt(vhat + 1e-30)
    lr = 3e-4 / 200
    whole = u / torch.clamp(torch.sqrt((u * u).mean() + 1e-30), min=1.0)
    per_layer = u / torch.clamp(torch.sqrt((u * u).mean(dim=(1, 2), keepdim=True) + 1e-30),
                                min=1.0)
    expect = before - lr * (whole + 0.1 * before)
    assert torch.allclose(values["stack/w"], expect, rtol=1e-5, atol=0)
    layer_rms = torch.sqrt((u * u).mean(dim=(1, 2)))
    assert layer_rms[1] > 10 * max(layer_rms[0], layer_rms[2])  # one layer sets the clip
    assert not torch.allclose(values["stack/w"], before - lr * (per_layer + 0.1 * before),
                              rtol=1e-5, atol=0)


@pytest.mark.parametrize("optimizer", ["adafactor", "sgdm"])
def test_zero_gradient_leaf(optimizer):
    """A leaf with a zero gradient (a frame arch's unread token embedding):
    Adafactor's ``g² + 1e-30`` stays representable in f32, ``u`` is 0, and
    only the decay moves a rank >= 2 leaf; SGDM leaves it in place. Both as
    the reference, over four updates."""
    zero = ("head", "final_norm")
    got, got_state, want, want_state = _run_both(optimizer, True, "float32", zero=zero,
                                                 learning_rate=1.0)
    before = _draw(0)
    for k in zero:
        assert err(got[k], want[k]) <= TOL, k
        assert np.isfinite(got[k]).all()
    np.testing.assert_array_equal(got["final_norm"], before["final_norm"])
    if optimizer == "adafactor":
        assert not np.array_equal(got["head"], before["head"])  # decayed
        assert np.all(np.abs(got["head"]) < np.abs(before["head"]) + 1e-7)
        assert np.all(got_state["v/head/vr"] > 0)
    else:
        np.testing.assert_array_equal(got["head"], before["head"])
        assert not got_state["mom/head"].any()


def test_adafactor_state_shapes():
    """Factored ``vr`` (the last axis averaged) and ``vc`` (axis -2
    averaged) for rank >= 2, keeping the layers axis; a full ``v`` for rank
    1; the master only with ``master_fp32``."""
    values = {k: torch.zeros(s) for k, s in SHAPES.items()}
    for master in (True, False):
        state = make_optimizer(RunConfig(optimizer="adafactor", master_fp32=master)).init(values)
        assert sorted(state) == (["master", "v"] if master else ["v"])
        shapes = {k: tuple(v.shape) for k, v in flatten_tree(state["v"]).items()}
        assert shapes == {"stack/w/vr": (3, 12), "stack/w/vc": (3, 16),
                          "stack/ln/vr": (3,), "stack/ln/vc": (16,),
                          "final_norm/v": (16,), "head/vr": (16,), "head/vc": (10,)}
        jstate = jmake_optimizer(RunConfig(optimizer="adafactor", master_fp32=master)).init(
            _nest({k: jnp.zeros(s) for k, s in SHAPES.items()}))
        assert shapes == {k[2:]: v.shape for k, v in _jax_flat(jstate).items()
                          if k.startswith("v/")}
    state = make_optimizer(RunConfig(optimizer="sgdm")).init(values)
    assert sorted(state) == ["master", "mom"]
    assert all(v.dtype == torch.float32 for v in flatten_tree(state).values())


@pytest.mark.parametrize("optimizer", ["adafactor", "sgdm"])
def test_descends(optimizer):
    """The reference's ``test_descends`` on the port: reduced tinyllama at
    lr 1e-3, five steps on one batch, the loss falls."""
    cfg = reduced(get_config("tinyllama-1.1b"))
    run = RunConfig(optimizer=optimizer, learning_rate=1e-3)
    model = build_model(cfg, device="cpu").init(0)
    opt = make_optimizer(run)
    state = fresh_train_state(model, opt)
    step = build_train_step(model, run, opt)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 65)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "targets": torch.from_numpy(toks[:, 1:]),
             "loss_mask": torch.ones((4, 64))}
    losses = []
    for _ in range(5):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("case", ["adafactor", "adafactor-no-master", "sgdm"])
def test_checkpoint_crosses_both_ways(tmp_path, case):
    """A port train state with these optimizers is restored by the
    reference's ``restore_checkpoint`` into its own state tree (same keys,
    same bits), and the reference's checkpoint back into the port."""
    optimizer, master, _ = CASES[case]
    cfg = reduced(get_config("tinyllama-1.1b"))
    run = RunConfig(optimizer=optimizer, master_fp32=master)
    model = build_model(cfg, device="cpu").init(3)
    opt = make_optimizer(run)
    state = fresh_train_state(model, opt)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "targets": torch.from_numpy(toks[:, 1:]),
             "loss_mask": torch.ones((2, 16))}
    state, _ = build_train_step(model, run, opt)(state, batch)  # non-zero moments
    ckpt.save_checkpoint(tmp_path / "port", 1, state)
    jmodel_values = jax.tree.map(jnp.asarray, _nest({
        k: to_numpy(v) for k, v in flatten_tree(state["values"]).items()}))
    jopt = jmake_optimizer(run)
    like = {"values": jax.tree.map(jnp.zeros_like, jmodel_values),
            "opt": jax.tree.map(jnp.zeros_like, jopt.init(jmodel_values)),
            "step": jnp.zeros((), jnp.int32)}
    restored = jckpt.restore_checkpoint(tmp_path / "port", 1, like)
    want = {k: to_numpy(v) for k, v in flatten_tree(state).items()}
    got = {k: np.asarray(v) for k, v in _jax_flat(restored).items()}
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # ... and back: the reference's save restored into a fresh port state.
    jckpt.save_checkpoint(tmp_path / "jax", 1, restored)
    fresh = fresh_train_state(build_model(cfg, device="cpu").init(5), make_optimizer(run))
    ckpt.restore_checkpoint(tmp_path / "jax", 1, fresh)
    back = {k: to_numpy(v) for k, v in flatten_tree(fresh).items()}
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
