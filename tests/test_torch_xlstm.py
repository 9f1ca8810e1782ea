"""The port's xLSTM cells (mLSTM and sLSTM) against the JAX package's.

Reduced xlstm-350m widths (``configs.reduced``: d_model 128, 4 heads; the
mLSTM inner width 256 in heads of 64, the sLSTM heads of 32), float32 on
both sides, the reference's own init moved across as numpy with its
zero-initialised leaves drawn non-zero: the norm scales, and the sLSTM's
recurrent matrices ``r_*``, which ``init_slstm`` multiplies by 0.0 and
which would otherwise leave the recurrent product untested. Tolerance:
scale-normalised max error (max |port - jax| / max |jax|) <= 1e-5 on the
block outputs and on every f32 state leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import xlstm as jx
from repro.models.common import RngStream, split_params
from repro_torch.models import xlstm

pytestmark = pytest.mark.torch_port

TOL = 1e-5


def err(port, ref) -> float:
    p = port.detach().double().numpy()
    r = np.asarray(ref, np.float64)
    return float(np.max(np.abs(p - r)) / (np.max(np.abs(r)) + 1e-6))


@pytest.fixture(scope="module")
def cfg():
    return reduced(get_config("xlstm-350m"))


def _params(init, cfg, seed):
    values, _ = split_params(init(RngStream(seed), cfg, jnp.float32))
    values = jax.tree.map(np.asarray, values)
    rng = np.random.default_rng(seed + 100)
    for name, leaf in values.items():
        if name == "out_norm":
            values[name] = (rng.normal(size=leaf.shape) * 0.2).astype(np.float32)
        elif name.startswith("r_"):
            assert not leaf.any()  # the reference's init zeroes them
            values[name] = (rng.normal(size=leaf.shape) / leaf.shape[-1] ** 0.5).astype(
                np.float32)
    return values


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)


def _state(shapes, seed, m_offset=0.0):
    rng = np.random.default_rng(seed)
    out = {k: (rng.normal(size=shp) * 0.5).astype(np.float32) for k, shp in shapes.items()}
    if "m" in out:
        out["m"] = out["m"] + np.float32(m_offset)
    if "n" in out and "c" in out:  # the sLSTM normaliser is a positive sum
        out["n"] = np.abs(out["n"]) + np.float32(1.0)
    return out


def test_state_shapes_match_jax(cfg):
    assert xlstm.mlstm_state_shape(cfg, 3) == jx.mlstm_state_shape(cfg, 3)
    assert xlstm.slstm_state_shape(cfg, 3) == jx.slstm_state_shape(cfg, 3)


@pytest.mark.parametrize("init,port_init", [(jx.init_mlstm, xlstm.init_mlstm),
                                            (jx.init_slstm, xlstm.init_slstm)])
def test_init_tree_matches_jax(cfg, init, port_init):
    want = _params(init, cfg, 0)
    got = port_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for name, leaf in got.items():
        if name.startswith("r_"):
            assert not leaf.any(), name  # drawn, then multiplied by 0.0
        if name.startswith("b_"):
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(init(
                RngStream(0), cfg, jnp.float32)[name].value))


@pytest.mark.parametrize("s,chunk", [(32, 8), (32, 256), (48, 16)])
@pytest.mark.parametrize("with_init", [False, True])
def test_mlstm_block_matches_jax(cfg, s, chunk, with_init):
    jp, tp = _both(_params(jx.init_mlstm, cfg, 1))
    x = _x(cfg, 2, s, 2)
    init = _state(jx.mlstm_state_shape(cfg, 2), 3) if with_init else None
    want, wst = jx.mlstm_block(jp, jnp.asarray(x), cfg, chunk=chunk,
                               init_state=None if init is None else _both(init)[0])
    got, st = xlstm.mlstm_block(tp, torch.from_numpy(x), cfg, chunk=chunk,
                                init_state=None if init is None else _both(init)[1])
    assert err(got, want) <= TOL
    for name in ("C", "n"):
        assert st[name].dtype == torch.float32
        assert err(st[name], wst[name]) <= TOL, name


def test_mlstm_chunk_rule_raises(cfg):
    _, tp = _both(_params(jx.init_mlstm, cfg, 1))
    with pytest.raises(ValueError, match="chunk"):
        xlstm.mlstm_block(tp, torch.zeros((1, 24, cfg.d_model)), cfg, chunk=16)
    with pytest.raises(ValueError, match="chunk"):
        xlstm.mlstm_block(tp, torch.zeros((1, 300, cfg.d_model)), cfg)
    xlstm.mlstm_block(tp, torch.zeros((1, 24, cfg.d_model)), cfg)  # chunk = min(256, 24)


def test_mlstm_decode_matches_jax(cfg):
    jp, tp = _both(_params(jx.init_mlstm, cfg, 4))
    state = _state(jx.mlstm_state_shape(cfg, 3), 5)
    js, ts = _both(state)
    x = _x(cfg, 3, 1, 6)
    for step in range(3):
        want, js = jx.mlstm_decode(jp, jnp.asarray(x + step), js, cfg)
        got, out_state = xlstm.mlstm_decode(tp, torch.from_numpy(x + step), ts, cfg)
        assert out_state is ts  # updated in place
        assert err(got, want) <= TOL, step
        for name in ("C", "n"):
            assert err(ts[name], js[name]) <= TOL, (step, name)


@pytest.mark.parametrize("s", [1, 24])
@pytest.mark.parametrize("with_init", [False, True])
def test_slstm_block_matches_jax(cfg, s, with_init):
    jp, tp = _both(_params(jx.init_slstm, cfg, 7))
    x = _x(cfg, 2, s, 8)
    init = _state(jx.slstm_state_shape(cfg, 2), 9, m_offset=3.0) if with_init else None
    want, wst = jx.slstm_block(jp, jnp.asarray(x), cfg,
                               init_state=None if init is None else _both(init)[0])
    got, st = xlstm.slstm_block(tp, torch.from_numpy(x), cfg,
                                init_state=None if init is None else _both(init)[1])
    assert err(got, want) <= TOL
    for name in ("c", "n", "h", "m"):
        assert st[name].dtype == torch.float32
        assert err(st[name], wst[name]) <= TOL, name


def test_slstm_decode_matches_jax(cfg):
    jp, tp = _both(_params(jx.init_slstm, cfg, 10))
    _, wst = jx.slstm_block(jp, jnp.asarray(_x(cfg, 3, 5, 11)), cfg)
    js = dict(wst)
    ts = {k: torch.from_numpy(np.array(v)) for k, v in wst.items()}
    x = _x(cfg, 3, 1, 12)
    for step in range(3):
        want, js = jx.slstm_decode(jp, jnp.asarray(x - step), js, cfg)
        got, out_state = xlstm.slstm_decode(tp, torch.from_numpy(x - step), ts, cfg)
        assert out_state is ts  # updated in place
        assert err(got, want) <= TOL, step
        for name in ("c", "n", "h", "m"):
            assert err(ts[name], js[name]) <= TOL, (step, name)
