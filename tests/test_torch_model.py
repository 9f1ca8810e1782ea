"""The port's model primitives and dense decoder against the JAX package.

Reduced tinyllama (``configs.reduced``: 2 layers, d_model 128, 4/2 heads,
head_dim 32, vocab 512), float32 on both sides, same weights moved across
with the bridge, same numpy inputs. Tolerance: scale-normalised max error
(max |port - jax| / max |jax|) <= 1e-5, which f32 reassociation stays far
below at these widths; the bridge itself is bit-exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models.common import split_params
from repro.models.transformer import build_model as jbuild
from repro.train.losses import lm_loss as jlm_loss
from repro_torch.models import attention, common, mlp
from repro_torch.models.convert import load_values, values_to_numpy
from repro_torch.models.transformer import build_model
from repro_torch.train.losses import lm_loss

pytestmark = pytest.mark.torch_port

TOL = 1e-5


def err(port, ref) -> float:
    p = port.detach().double().numpy() if isinstance(port, torch.Tensor) else port
    r = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(p, np.float64) - r)) / (np.max(np.abs(r)) + 1e-6))


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def cfg():
    return reduced(get_config("tinyllama-1.1b"))


def _jax_values(cfg, seed=0):
    values, _ = split_params(jbuild(cfg).init(seed))
    return jax.tree.map(np.asarray, values)


def _port_model(cfg, values):
    model = build_model(cfg, device="cpu")
    load_values(model, values)
    return model


def test_rms_norm(cfg):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 128)).astype(np.float32)
    scale = rng.normal(size=(128,)).astype(np.float32) * 0.1
    want = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
    assert err(common.rms_norm(t(x), t(scale), 1e-5), want) <= TOL


@pytest.mark.parametrize("head_dim", [32, 7])
def test_rope(head_dim):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, head_dim)).astype(np.float32)
    pos = np.arange(9)[None, :] + 100
    js, jc = jcommon.make_rope(jnp.asarray(pos), head_dim, 10_000.0)
    ps, pc = common.make_rope(t(pos), head_dim, 10_000.0)
    assert err(ps, js) <= TOL and err(pc, jc) <= TOL
    want = jcommon.apply_rope(jnp.asarray(x), js, jc)
    got = common.apply_rope(t(x), ps, pc)
    assert err(got, want) <= TOL
    if head_dim % 2:
        np.testing.assert_array_equal(got[..., -1].numpy(), x[..., -1])


def _qkv(cfg, s=64, seed=2):
    rng = np.random.default_rng(seed)
    shape = (2, s, cfg.num_heads, cfg.head_dim_)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("window", [0, 24])
def test_dense_attention(cfg, window):
    c = dataclasses.replace(cfg, window=window)
    q, k, v = _qkv(c)
    want = jattn._dense_attention(*map(jnp.asarray, (q, k, v)), c)
    assert err(attention._dense_attention(t(q), t(k), t(v), c), want) <= TOL


def test_chunked_attention(cfg):
    c = dataclasses.replace(cfg, attn_chunk=16)
    q, k, v = _qkv(c)
    want = jattn._chunked_attention(*map(jnp.asarray, (q, k, v)), c)
    assert err(attention._chunked_attention(t(q), t(k), t(v), c), want) <= TOL


@pytest.mark.parametrize("threshold", [2048, 32])  # dense, then chunked
def test_attention_block(cfg, threshold):
    c = dataclasses.replace(cfg, attn_dense_threshold=threshold, attn_chunk=16)
    values = _jax_values(c)
    p = values["segments"][0]["attn"]
    p0 = {k: v[0] for k, v in p.items()}
    x = np.random.default_rng(3).normal(size=(2, 64, c.d_model)).astype(np.float32)
    want, (wk, wv) = jattn.attention_block(jax.tree.map(jnp.asarray, p0), jnp.asarray(x), c)
    got, (gk, gv) = attention.attention_block({k: t(v) for k, v in p0.items()}, t(x), c)
    assert err(got, want) <= TOL
    assert err(gk, wk) <= TOL and err(gv, wv) <= TOL


def test_expand_kv_is_repeat_interleave(cfg):
    k = np.arange(2 * 3 * cfg.num_kv_heads * 4, dtype=np.float32).reshape(
        2, 3, cfg.num_kv_heads, 4)
    want = np.asarray(jattn._expand_kv(jnp.asarray(k), cfg))
    np.testing.assert_array_equal(attention._expand_kv(t(k), cfg).numpy(), want)


def test_mlp_block(cfg):
    values = _jax_values(cfg)
    p0 = {k: v[0] for k, v in values["segments"][0]["mlp"].items()}
    x = np.random.default_rng(4).normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    want = jmlp.mlp_block(jax.tree.map(jnp.asarray, p0), jnp.asarray(x))
    assert err(mlp.mlp_block({k: t(v) for k, v in p0.items()}, t(x)), want) <= TOL


def test_lm_loss():
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(2, 16, 64)) * 3).astype(np.float32)
    targets = rng.integers(0, 64, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) < 0.7).astype(np.float32)
    want, wm = jlm_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask))
    got, gm = lm_loss(t(logits), t(targets), t(mask))
    assert err(got, want) <= TOL
    for k in ("ce", "z_loss"):
        assert err(gm[k], wm[k]) <= TOL
    zero, _ = lm_loss(t(logits), t(targets), t(np.zeros_like(mask)))
    assert float(zero) == 0.0  # denominator max(sum(mask), 1)


@pytest.mark.parametrize("threshold", [2048, 32])
def test_forward_logits(cfg, threshold):
    c = dataclasses.replace(cfg, attn_dense_threshold=threshold, attn_chunk=16)
    values = _jax_values(c, seed=1)
    # Non-zero norm scales, so the (1 + scale) gain is exercised.
    rng = np.random.default_rng(6)
    seg = values["segments"][0]
    for name in ("ln1", "ln2"):
        seg[name] = (rng.normal(size=seg[name].shape) * 0.2).astype(np.float32)
    values["final_norm"] = (rng.normal(size=values["final_norm"].shape) * 0.2).astype(
        np.float32)
    tokens = rng.integers(0, c.vocab_size, (2, 64)).astype(np.int32)
    want, _, _ = jbuild(c).forward(jax.tree.map(jnp.asarray, values),
                                   {"tokens": jnp.asarray(tokens)})
    model = _port_model(c, values)
    got, aux = model({"tokens": t(tokens)})
    assert got.shape == (2, 64, c.vocab_size) and float(aux) == 0.0
    assert err(got, want) <= TOL


def test_remat_changes_no_number(cfg):
    values = _jax_values(cfg)
    model = _port_model(cfg, values)
    tokens = t(np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))
    out = {}
    for remat in ("none", "dots"):
        model.zero_grad()
        logits, _ = model({"tokens": tokens}, remat=remat)
        logits.float().square().mean().backward()
        out[remat] = (logits.detach(), [p.grad.clone() for p in model.parameters()])
    assert torch.equal(out["none"][0], out["dots"][0])
    for a, b in zip(out["none"][1], out["dots"][1]):
        assert torch.allclose(a, b, rtol=0, atol=0)


def test_state_dict_names_are_reference_tree_paths(cfg):
    from repro_torch.models.common import flatten_tree

    model = build_model(cfg, device="cpu")
    names = {k.replace(".", "/") for k in model.state_dict()}
    assert names == set(flatten_tree(_jax_values(cfg)))
    assert model.segments[0].ln1.shape == (cfg.num_layers, cfg.d_model)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_bit_exact(cfg, dtype):
    c = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    values = _jax_values(c, seed=3)
    model = _port_model(c, values)
    back = values_to_numpy(model)
    flat_in = jax.tree_util.tree_leaves(values)
    flat_out = jax.tree_util.tree_leaves(back)
    assert len(flat_in) == len(flat_out)
    for a, b in zip(flat_in, flat_out):
        if dtype == "bfloat16":
            assert a.dtype == ml_dtypes.bfloat16 and b.dtype == np.uint16
            a = a.view(np.uint16)
        np.testing.assert_array_equal(a, b)
    assert model.embed.dtype == getattr(torch, dtype)


def test_unported_kinds_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(reduced(get_config("zamba2-1.2b")), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(reduced(get_config("llava-next-34b")), device="cpu")
