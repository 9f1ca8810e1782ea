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


#: ``_chunked_attention_vecq`` cases: (causal, window, GQA). The q/k/v of a
#: GQA case are drawn at the kv heads and expanded, as ``attention_block``
#: passes them. With a window the first kv blocks of late rows are fully
#: masked: vecq zeroes their ``p`` and ``_chunked_attention`` adds
#: ``exp(NEG_INF - NEG_INF) = 1`` there, which the next block's
#: ``corr = exp(NEG_INF - m) = 0`` wipes, so both agree with the dense path.
VECQ_CASES = {"causal": (True, 0, False), "non-causal": (False, 0, False),
              "window": (True, 20, False), "non-causal-window": (False, 20, False),
              "gqa-expanded": (True, 0, True)}


@pytest.mark.parametrize("case", list(VECQ_CASES))
def test_chunked_attention_vecq(cfg, case):
    causal, window, gqa = VECQ_CASES[case]
    c = dataclasses.replace(cfg, attn_chunk=16, causal=causal, window=window)
    q, k, v = _qkv(c, s=64)
    if gqa:
        rng = np.random.default_rng(7)
        k, v = (np.repeat(rng.normal(size=(2, 64, c.num_kv_heads, c.head_dim_)).astype(
            np.float32), c.num_heads // c.num_kv_heads, axis=2) for _ in range(2))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jattn._chunked_attention_vecq(jq, jk, jv, c)
    got = attention._chunked_attention_vecq(t(q), t(k), t(v), c)
    assert got.shape == (2, 64, c.num_heads, c.head_dim_)
    assert err(got, want) <= TOL
    # All three attention paths compute one function under every mask here.
    assert err(got, jattn._chunked_attention(jq, jk, jv, c)) <= TOL
    assert err(got, jattn._dense_attention(jq, jk, jv, c)) <= TOL


def test_chunked_attention_vecq_refuses_a_ragged_sequence(cfg):
    c = dataclasses.replace(cfg, attn_chunk=16)
    q, k, v = _qkv(c, s=40)
    with pytest.raises(ValueError, match="multiple of attn_chunk"):
        attention._chunked_attention_vecq(t(q), t(k), t(v), c)


@pytest.mark.parametrize("shard,threshold,path", [
    ("seq", 32, "_chunked_attention_vecq"), ("seq", 2048, "_dense_attention"),
    ("heads", 32, "_chunked_attention")])
def test_attention_block_dispatches_vecq_for_seq_sharding(cfg, shard, threshold, path,
                                                         monkeypatch):
    """``attn_shard="seq"`` above ``attn_dense_threshold`` takes the vecq
    path, at or below it the dense one; ``"heads"`` above it the chunked
    one: the reference's dispatch, output within TOL of the reference's."""
    c = dataclasses.replace(cfg, attn_shard=shard, attn_dense_threshold=threshold,
                            attn_chunk=16)
    called = []
    for name in ("_chunked_attention_vecq", "_dense_attention", "_chunked_attention"):
        fn = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *a, _fn=fn, _name=name: called.append(_name) or _fn(*a))
    p0 = {k: v[0] for k, v in _jax_values(c)["segments"][0]["attn"].items()}
    x = np.random.default_rng(3).normal(size=(2, 64, c.d_model)).astype(np.float32)
    want, _ = jattn.attention_block(jax.tree.map(jnp.asarray, p0), jnp.asarray(x), c)
    got, _ = attention.attention_block({k: t(v) for k, v in p0.items()}, t(x), c)
    assert called == [path]
    assert err(got, want) <= TOL


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
    """Every registered arch builds, with ``moe_impl="a2a"`` too; that
    one's forward raises without a mesh whose "model" axis it needs. The
    archs the JAX package registers build from its configurations; the
    port's own (nemotron-h) from the port's."""
    from repro.configs import ARCHS as J_ARCHS
    from repro_torch.configs import get_config as port_config
    from repro_torch.configs import list_archs
    from repro_torch.configs import reduced as port_reduced

    for arch in list_archs():
        if arch in J_ARCHS:
            build_model(reduced(get_config(arch)), device="cpu")
        else:
            build_model(port_reduced(port_config(arch)), device="cpu")
    cfg = dataclasses.replace(reduced(get_config("deepseek-moe-16b")), moe_impl="a2a")
    model = build_model(cfg, device="cpu").init(0)
    with pytest.raises(RuntimeError, match="sharding ctx"):
        model({"tokens": torch.zeros((1, 8), dtype=torch.int32)})


# ------------------------------------------------------------------ hybrid
@pytest.fixture(scope="module")
def hcfg():
    return reduced(get_config("zamba2-1.2b"))


def test_hybrid_tree_and_state_dict_names(hcfg):
    """The reference's tree: stacked Mamba-2 segments, ``{}`` at each shared
    site, one unstacked ``shared_attn`` block; parameters counted as the
    leaves hold them."""
    from repro_torch.models.common import flatten_tree

    model = build_model(hcfg, device="cpu")
    jvalues = _jax_values(hcfg)
    assert [bool(seg) for seg in jvalues["segments"]] == [True, False, True, False]
    assert model.values()["segments"][1] == {} and "shared_attn" in model.values()
    names = {k.replace(".", "/") for k in model.state_dict()}
    assert names == set(flatten_tree(jvalues))
    assert model.shared_attn.attn["wq"].shape == (hcfg.d_model, hcfg.num_heads * 32)
    assert model.segments[0].mixer["A_log"].shape == (2, hcfg.d_inner // hcfg.ssm_head_dim)
    real = sum(p.numel() for p in model.parameters())
    assert real == sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(jvalues))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_bridge_round_trip_is_bit_exact(hcfg, dtype):
    c = dataclasses.replace(hcfg, param_dtype=dtype, compute_dtype=dtype)
    values = _jax_values(c, seed=4)
    model = _port_model(c, values)
    back = values_to_numpy(model)
    assert back["segments"][1] == {} and back["segments"][3] == {}
    flat_in = jax.tree_util.tree_leaves(values)
    flat_out = jax.tree_util.tree_leaves(back)
    assert len(flat_in) == len(flat_out) == len(model.state_dict())
    for a, b in zip(flat_in, flat_out):
        if dtype == "bfloat16":
            assert a.dtype == ml_dtypes.bfloat16 and b.dtype == np.uint16
            a = a.view(np.uint16)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_hybrid_forward_logits(hcfg, remat):
    """The training route: plain chunked scan (chunk 16 divides S = 32) and
    the shared block's dense attention, with and without per-layer remat."""
    c = dataclasses.replace(hcfg, ssm_chunk=16)
    values = _jax_values(c, seed=2)
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, c.vocab_size, (2, 32)).astype(np.int32)
    want, _, _ = jbuild(c).forward(jax.tree.map(jnp.asarray, values),
                                   {"tokens": jnp.asarray(tokens)})
    model = _port_model(c, values)
    got, aux = model({"tokens": t(tokens)}, remat=remat)
    assert got.shape == (2, 32, c.vocab_size) and float(aux) == 0.0
    assert err(got, want) <= TOL


# ------------------------------------------------------ MoE and xLSTM
#: The reduced forms of the MoE family (deepseek-moe-16b: a dense first
#: layer at ``moe_dense_ff``, then MoE layers with a shared expert;
#: kimi-k2-1t-a32b: GQA 4/2, capacity factor 1.0) and of xLSTM
#: (mLSTM, sLSTM, mLSTM, sLSTM).
FAMILIES = ["deepseek-moe-16b", "kimi-k2-1t-a32b", "xlstm-350m"]


def family_values(cfg, seed=0):
    """JAX-initialised weights as numpy, with the leaves that init leaves at
    0 drawn non-zero (norm scales; the sLSTM's recurrent ``r_*``, which
    ``init_slstm`` multiplies by 0.0)."""
    values = _jax_values(cfg, seed)
    rng = np.random.default_rng(seed + 50)

    def walk(tree):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                walk(leaf)
            elif name.startswith(("ln", "out_norm")):
                tree[name] = (rng.normal(size=leaf.shape) * 0.2).astype(leaf.dtype)
            elif name.startswith("r_"):
                tree[name] = (rng.normal(size=leaf.shape) / leaf.shape[-1] ** 0.5).astype(
                    leaf.dtype)

    for seg in values["segments"]:
        walk(seg)
    values["final_norm"] = (rng.normal(size=values["final_norm"].shape) * 0.2).astype(
        values["final_norm"].dtype)
    return values


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_tree_and_state_dict_names(arch):
    cfg = reduced(get_config(arch))
    model = build_model(cfg, device="cpu")
    jvalues = _jax_values(cfg)
    from repro_torch.models.common import flatten_tree

    names = {k.replace(".", "/") for k in model.state_dict()}
    assert names == set(flatten_tree(jvalues))
    for path, leaf in flatten_tree(jvalues).items():
        assert tuple(flatten_tree(model.values())[path].shape) == leaf.shape, path
    real = sum(p.numel() for p in model.parameters())
    assert real == sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(jvalues))
    model.init(0)  # the port's own draws fill every leaf
    assert all(torch.isfinite(p).all() for p in model.parameters())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_bridge_round_trip_is_bit_exact(arch, dtype):
    c = dataclasses.replace(reduced(get_config(arch)), param_dtype=dtype, compute_dtype=dtype)
    values = _jax_values(c, seed=5)
    model = _port_model(c, values)
    back = values_to_numpy(model)
    flat_in = jax.tree_util.tree_leaves(values)
    flat_out = jax.tree_util.tree_leaves(back)
    assert len(flat_in) == len(flat_out) == len(model.state_dict())
    for a, b in zip(flat_in, flat_out):
        if dtype == "bfloat16":
            assert a.dtype == ml_dtypes.bfloat16 and b.dtype == np.uint16
            a = a.view(np.uint16)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch,remat", [("deepseek-moe-16b", "none"),
                                        ("deepseek-moe-16b", "dots"),
                                        ("kimi-k2-1t-a32b", "none"),
                                        ("xlstm-350m", "none"), ("xlstm-350m", "full")])
def test_family_forward_logits(arch, remat):
    """Logits and the summed MoE aux (two MoE layers: the capacity drops
    some of S = 32's assignments) on the training route, with and without
    per-layer remat; for xLSTM one mLSTM chunk (``min(256, S)``) and 32
    sLSTM steps."""
    cfg = reduced(get_config(arch))
    values = family_values(cfg, seed=2)
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    want, want_aux, _ = jbuild(cfg).forward(jax.tree.map(jnp.asarray, values),
                                            {"tokens": jnp.asarray(tokens)})
    model = _port_model(cfg, values)
    got, aux = model({"tokens": t(tokens)}, remat=remat)
    assert got.shape == (2, 32, cfg.vocab_size) and aux.dtype == torch.float32
    assert err(got, want) <= TOL
    assert err(aux, want_aux) <= TOL
    assert (float(aux.detach()) > 0) == bool(cfg.moe_num_experts)
