"""The port's serving path against the JAX package's.

Reduced tinyllama (2 layers, d_model 128, 4/2 heads, head_dim 32, vocab
512) in float32 on both sides, the same weights moved across with the
bridge, the same numpy prompts: ``build_prefill_step`` then greedy
``build_decode_step``, in four variants (full cache; a 16-slot rotating
window that the 24-token prompt overfills; an int8 cache; logits capped
at ``logit_softcap`` 50). Reduced zamba2 (4 Mamba-2 blocks, the shared
attention block at 2 sites) the same way, with a full cache, an
overfilled window and the softcap, every cache leaf (``ssm``, ``conv``,
``k``, ``v``) compared. Tolerance:
scale-normalised max error (max |port - jax| / max |jax|) <= 1e-5 for
logits and float cache leaves, which f32 reassociation stays far below at
these widths, and greedy tokens equal.

The int8 variant is held to one quantisation code on the int8 leaves and
to ``INT8_TOL`` on the decode logits. Port and JAX K/V agree to ~1e-7
relative in f32, so ``round(t / scale)`` can land on the other side of a
.5 boundary for a rare element, which moves that element by one code
(1/127 of its row's max) and every later logit with it: at these inputs
the prefill's 16,384 codes all agree, and one code written at decode step
3 differs, which moves that step's logits by 2.8e-4 of their max. The
bound 1e-3 leaves room for a few such flips and is still 50x below what
int8 itself costs against a float cache (5e-2, ``tests/test_kv_quant.py``).
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import build_model as jbuild
from repro.models import split_params
from repro.models.attention import dequantize_kv as jdequantize_kv
from repro.models.attention import quantize_kv as jquantize_kv
from repro.train.train_step import build_decode_step as jbuild_decode_step
from repro.train.train_step import build_prefill_step as jbuild_prefill_step
from repro_torch.launch import serve as port_serve
from repro_torch.models.attention import dequantize_kv, quantize_kv
from repro_torch.models.convert import load_values
from repro_torch.models.transformer import build_model
from repro_torch.train.train_step import build_decode_step, build_prefill_step

pytestmark = pytest.mark.torch_port

TOL = 1e-5
INT8_TOL = 1e-3
#: The decode-vs-prefill bound ``chip_smoke.py`` holds the full-width bf16
#: run to (scale-normalised error, and argmax agreeing on 7 of 8 rows).
SMOKE_AGREEMENT_TOL = 5e-2


def err(port, ref) -> float:
    p = port.detach().double().numpy()
    r = np.asarray(ref, np.float64)
    return float(np.max(np.abs(p - r)) / (np.max(np.abs(r)) + 1e-6))


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a)


def test_quantize_kv_matches_jax_exactly():
    rng = np.random.default_rng(0)
    t = rng.normal(size=(2, 7, 3, 32)).astype(np.float32) * 3
    t[0, 0, 0] = 0.0  # the 1e-8 floor
    t[1, 2, 1, :4] = [0.5, -0.5, 1.5, 127.0]  # ties round half to even
    jq, js = jquantize_kv(jnp.asarray(t))
    q, s = quantize_kv(torch.from_numpy(t))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16 and s.shape == (2, 7, 3, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.view(torch.int16).numpy(), np.asarray(js).view(np.int16))
    back = dequantize_kv(q, s, torch.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jdequantize_kv(jq, js, jnp.float32)))


VARIANTS = {
    # name: (config changes, prompt length, max_len)
    "full": ({}, 16, 32),
    "window": ({"window": 16}, 24, 40),
    "int8": ({"kv_cache_dtype": "int8"}, 16, 32),
    # Gemma 2's attn_logit_softcapping (arXiv:2408.00118, Table 1): both
    # attention kernels cap the logits, as the reference's jnp does.
    "softcap": ({"logit_softcap": 50.0}, 16, 32),
}


def _perturb_recurrent(values, seed=3):
    """The sLSTM's ``r_*`` drawn non-zero on numpy leaves (``init_slstm``
    multiplies them by 0.0, which would leave the recurrent product
    untested); other trees pass unchanged."""
    rng = np.random.default_rng(seed)
    for seg in values["segments"]:
        for name, leaf in seg.get("cell", {}).items():
            if name.startswith("r_"):
                seg["cell"][name] = (rng.normal(size=leaf.shape) / leaf.shape[-1] ** 0.5
                                     ).astype(leaf.dtype)
    return values


def _prefill_and_decode_match_jax(cfg, prompt_len, max_len):
    jmodel = jbuild(cfg)
    values, _ = split_params(jmodel.init(1))
    values = _perturb_recurrent(jax.tree.map(np.asarray, values))
    model = build_model(cfg, device="cpu")
    load_values(model, values)
    values = jax.tree.map(jnp.asarray, values)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, prompt_len)).astype(np.int32)

    jlogits, jcache = jax.jit(jbuild_prefill_step(jmodel, max_len))(
        values, {"tokens": jnp.asarray(prompts)})
    logits, cache = build_prefill_step(model, max_len)({"tokens": torch.from_numpy(prompts)})
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert err(logits, jlogits) <= TOL

    def check_cache():
        assert len(cache) == len(jcache)
        for seg, jseg in zip(cache, jcache):
            assert sorted(seg) == sorted(jseg)
            for name, leaf in seg.items():
                want = jseg[name]
                assert tuple(leaf.shape) == want.shape, name
                assert str(leaf.dtype).split(".")[1] == want.dtype.name, name
                if leaf.dtype == torch.int8:
                    diff = np.abs(leaf.numpy().astype(np.int32) - np.asarray(want, np.int32))
                    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
                else:
                    assert err(leaf.float(), _np(want)) <= TOL, name

    check_cache()
    attn = [i for i, (kind, _) in enumerate(cfg.segments())
            if kind in ("attn_mlp", "shared_attn")]
    if 0 < cfg.window < prompt_len:  # the prompt overfilled the window: the ring rotated
        assert cache[attn[0]]["k"].shape[2] == cfg.window

    tol = INT8_TOL if cfg.kv_cache_dtype == "int8" else TOL
    jdecode = jax.jit(jbuild_decode_step(jmodel))
    decode = build_decode_step(model)
    jtok = jnp.argmax(jlogits[:, -1], -1)[:, None].astype(jnp.int32)
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    for t in range(8):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        jlogits, jcache = jdecode(values, jcache, jtok, jnp.int32(prompt_len + t))
        logits, cache = decode(cache, tok, prompt_len + t)
        assert err(logits, jlogits) <= tol, t
        jtok = jnp.argmax(jlogits[:, 0], -1)[:, None].astype(jnp.int32)
        tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    check_cache()  # the in-place updates equal JAX's returned caches


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_match_jax(variant):
    changes, prompt_len, max_len = VARIANTS[variant]
    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")), **changes)
    _prefill_and_decode_match_jax(cfg, prompt_len, max_len)


HYBRID_VARIANTS = {
    # name: (config changes, prompt length, max_len)
    "full": ({}, 16, 32),
    "window": ({"window": 16}, 24, 40),
    "softcap": ({"logit_softcap": 50.0}, 16, 32),
}


@pytest.mark.parametrize("variant", list(HYBRID_VARIANTS))
def test_hybrid_prefill_and_decode_match_jax(variant):
    """Reduced zamba2: the ssd_scan entry's plain version in the prefill,
    the shared block's per-site KV caches, the in-place SSM and conv state
    updates of decode."""
    changes, prompt_len, max_len = HYBRID_VARIANTS[variant]
    cfg = dataclasses.replace(reduced(get_config("zamba2-1.2b")), **changes)
    assert [k for k, _ in cfg.segments()] == ["mamba2", "shared_attn"] * 2
    _prefill_and_decode_match_jax(cfg, prompt_len, max_len)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "kimi-k2-1t-a32b", "xlstm-350m"])
def test_family_prefill_and_decode_match_jax(arch):
    """Reduced MoE (a 16-token prefill at capacity 5 per expert drops
    assignments, as the reference's does; decode's cap 1 drops none) and
    xLSTM (the mLSTM ``C``/``n`` and sLSTM ``c``/``n``/``h``/``m`` states
    written by the prefill and updated in place by decode): logits, greedy
    tokens and every cache leaf against the reference's."""
    cfg = reduced(get_config(arch))
    _prefill_and_decode_match_jax(cfg, 16, 32)


def _args(**kw):
    base = dict(arch="tinyllama-1.1b", batch=8, prompt_len=24, new_tokens=12, seed=0,
                full=False, list_archs=False, device="cpu")
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("dtype,layers,head_dim", [("float32", 2, 32), ("bfloat16", 22, 64)])
def test_decode_matches_fresh_prefill(dtype, layers, head_dim, monkeypatch):
    """The check ``chip_smoke.py`` makes at full width, here at reduced
    widths. In f32 decode and prefill agree to reassociation (<= 1e-5). In
    bf16 the two paths round at different places (the kernels' p cast,
    GEMMs of other shapes); on the CPU that shows only at tinyllama's depth
    and head dim (22 layers, 64), which this case keeps. Its errors, printed
    with ``-s``, ground the smoke's bound."""
    cfg = reduced(get_config("tinyllama-1.1b"))
    cfg = dataclasses.replace(cfg, num_layers=layers, head_dim=head_dim, param_dtype=dtype,
                              compute_dtype=dtype)
    monkeypatch.setattr(port_serve, "reduced", lambda _: cfg)
    steps = (0, 4, 7, 10)
    summary = port_serve.serve(_args(), keep_logits=steps)
    assert summary["tokens"].shape == (8, 12) and sorted(summary["logits"]) == list(steps)
    assert summary["prefill_s"] > 0 and summary["decode_s"] > 0
    rows = port_serve.prefill_agreement(summary, steps)
    print(f"{dtype}, {layers} layers: " + ", ".join(
        f"step {r['step']}: err {r['err']:.3e}, argmax {r['argmax_agree']}/{r['rows']}"
        for r in rows))
    for r in rows:
        if dtype == "float32":
            assert r["err"] <= TOL and r["argmax_agree"] == r["rows"]
        else:
            assert r["err"] <= SMOKE_AGREEMENT_TOL and r["argmax_agree"] >= 7


#: The hybrid decode-vs-prefill bounds ``chip_smoke.py`` holds the
#: full-width bf16 run to: logits as above; the recurrent states, per leaf,
#: the worst per-layer scale-normalised error.
SMOKE_STATE_TOL = {"mamba2.ssm": 1e-1, "mamba2.conv": 5e-2}


@pytest.mark.parametrize("dtype,layers", [("float32", 4), ("bfloat16", 38)])
def test_hybrid_decode_matches_fresh_prefill(dtype, layers, monkeypatch):
    """The check ``chip_smoke.py`` makes on zamba2 at full width, here at
    reduced widths: decode logits and the SSM and conv states after a step
    against a fresh prefill of the same tokens. In f32 they agree to
    reassociation. In bf16 the case keeps Zamba2's depth (38 Mamba-2
    blocks, the shared block after every 6th), its SSM head dim and state
    (64, 64) and attention head dim (64); its errors, printed with ``-s``,
    ground the smoke's bounds."""
    cfg = reduced(get_config("zamba2-1.2b"))
    if dtype == "bfloat16":
        cfg = dataclasses.replace(cfg, num_layers=layers, attn_every=6, head_dim=64,
                                  ssm_head_dim=64, ssm_state=64, param_dtype=dtype,
                                  compute_dtype=dtype)
    monkeypatch.setattr(port_serve, "reduced", lambda _: cfg)
    steps = (0, 4, 7, 10)
    summary = port_serve.serve(_args(arch="zamba2-1.2b"), keep_logits=steps, keep_states=steps)
    assert sorted(summary["states"]) == list(steps)
    rows = port_serve.prefill_agreement(summary, steps)
    print(f"{dtype}, {layers} layers: " + ", ".join(
        f"step {r['step']}: err {r['err']:.3e}, argmax {r['argmax_agree']}/{r['rows']}, "
        f"ssm {r['state_err']['mamba2.ssm']:.3e}, conv {r['state_err']['mamba2.conv']:.3e}"
        for r in rows))
    for r in rows:
        if dtype == "float32":
            assert r["err"] <= TOL and r["argmax_agree"] == r["rows"]
            assert max(r["state_err"].values()) <= TOL
        else:
            assert r["err"] <= SMOKE_AGREEMENT_TOL and r["argmax_agree"] >= 7
            assert all(r["state_err"][k] <= SMOKE_STATE_TOL[k] for k in SMOKE_STATE_TOL)


#: The capacity factor at which no MoE prefill assignment drops, so that
#: decode (one token: cap 1, its top-k experts distinct, nothing dropped)
#: and a fresh prefill compute the same function: ``cap = int(s * k * cf /
#: e) >= s`` whenever ``k * cf >= e``, as at deepseek-moe-16b's 6 * 11 / 64
#: and the reduced 2 * 11 / 8. ``chip_smoke.py`` phase 9 checks at it.
NO_DROP_CAPACITY = 11.0
#: The bound ``chip_smoke.py`` phases 9 and 10 hold decode's logits to
#: against a fresh prefill, in f32 (scale-normalised error, and argmax
#: equal on every row). In
#: bf16 the two paths round differently, and MoE routing turns a rounding
#: difference into another expert (``test_moe_bf16_decode_drifts_by_routing``)
#: and the sLSTM's exponential gates amplify it, so that a sound bf16 run
#: reads as far from its prefill as a cache missing one token does; in f32
#: they agree to reassociation (the f32 cases below, at depth).
SMOKE_F32_TOL = 1e-3


def _moe_cfg(dtype, layers, head_dim, capacity=NO_DROP_CAPACITY):
    return dataclasses.replace(reduced(get_config("deepseek-moe-16b")), num_layers=layers,
                               head_dim=head_dim, capacity_factor=capacity,
                               param_dtype=dtype, compute_dtype=dtype)


def _agreement(arch, cfg, steps, monkeypatch, **kw):
    monkeypatch.setattr(port_serve, "reduced", lambda _: cfg)
    summary = port_serve.serve(_args(arch=arch), keep_logits=steps, **kw)
    return summary, port_serve.prefill_agreement(summary, steps)


def _show(label, rows):
    print(f"{label}: " + "; ".join(
        f"step {r['step']}: err {r['err']:.3e}, argmax {r['argmax_agree']}/{r['rows']}"
        + "".join(f", {k} {v:.3e}" for k, v in r.get("state_err", {}).items())
        for r in rows))


@pytest.mark.parametrize("layers,head_dim", [(2, 32), (28, 128)])
def test_moe_decode_matches_fresh_prefill(layers, head_dim, monkeypatch):
    """The check ``chip_smoke.py`` makes on deepseek-moe-16b in f32 at full
    width, here at reduced widths, the second case at its depth (28 layers)
    and head dim (128), at ``NO_DROP_CAPACITY``: decode agrees with a fresh
    prefill to reassociation. Its errors, printed with ``-s``, ground the
    smoke's bound."""
    _, rows = _agreement("deepseek-moe-16b", _moe_cfg("float32", layers, head_dim),
                         (0, 4, 7, 10), monkeypatch)
    _show(f"float32, {layers} layers", rows)
    for r in rows:
        assert r["err"] <= TOL and r["argmax_agree"] == r["rows"]


def test_moe_bf16_decode_drifts_by_routing(monkeypatch):
    """In bf16 at deepseek-moe-16b's depth, decode and a fresh prefill round
    the router's inputs differently, and where two experts' scores lie within
    that rounding the top-k picks another expert: whole rows of logits move
    (0 in the rows where no token flipped). Measured: up to 2.0e-1 by step
    10, above the f32 check's bound, with argmax still equal on >= 7 of 8
    rows; this is why ``chip_smoke.py`` checks the MoE in f32."""
    _, rows = _agreement("deepseek-moe-16b", _moe_cfg("bfloat16", 28, 128),
                         (0, 4, 7, 10), monkeypatch)
    _show("bfloat16, 28 layers", rows)
    assert all(r["argmax_agree"] >= 7 for r in rows)
    assert max(r["err"] for r in rows) > SMOKE_F32_TOL


def test_moe_capacity_drops_make_prefill_differ_from_decode(monkeypatch):
    """At the configured capacity factor (1.25) a fresh prefill drops the
    later tokens' assignments, which decode never drops: the two differ by
    design, in the reference as here, so the agreement check needs
    ``NO_DROP_CAPACITY``."""
    cfg = _moe_cfg("float32", 2, 32, capacity=1.25)
    assert cfg.capacity_factor == get_config("deepseek-moe-16b").capacity_factor
    _, rows = _agreement("deepseek-moe-16b", cfg, (4, 10), monkeypatch)
    assert max(r["err"] for r in rows) > 100 * TOL


#: The state bounds of ``chip_smoke.py``'s f32 xLSTM check, per leaf
#: (``XLSTM_STATE_TOL`` there says where each comes from).
SMOKE_XLSTM_STATE_TOL = {"mlstm.C": 1e-3, "mlstm.n": 1e-3, "slstm.c": 2e-2,
                         "slstm.n": 2e-2, "slstm.h": 1e-2, "slstm.m": 5e-4}


@pytest.mark.parametrize("dtype,layers,d_model", [("float32", 4, 128), ("float32", 24, 256),
                                                  ("bfloat16", 24, 256)])
def test_xlstm_decode_matches_fresh_prefill(dtype, layers, d_model, monkeypatch):
    """The check ``chip_smoke.py`` makes on xlstm-350m at full width, here
    at reduced widths: decode logits and every mLSTM and sLSTM state after
    a step against a fresh prefill of the same tokens, and the states one
    token stale as a planted fault, which must read above the bounds. In
    f32 (the smoke's check) they agree to reassociation: within 1e-5 at 4
    blocks, within 4.3e-5 at xlstm-350m's depth (24 blocks, every 8th
    sLSTM), which grounds the smoke's bounds. In bf16 the sLSTM's ``c`` and
    ``n`` read 1.6e-1, as far as a stale state's 3.9e-1 nearly; this case
    only shows it. Errors print with ``-s``."""
    cfg = reduced(get_config("xlstm-350m"))
    cfg = dataclasses.replace(cfg, num_layers=layers, d_model=d_model, param_dtype=dtype,
                              compute_dtype=dtype,
                              slstm_every=cfg.slstm_every if layers == 4 else 8)
    steps = (0, 4, 7, 10)
    summary, rows = _agreement("xlstm-350m", cfg, steps, monkeypatch,
                               keep_states=steps + (9,))
    (stale,) = port_serve.prefill_agreement(
        {**summary, "states": {10: summary["states"][9]}}, (10,))
    _show(f"{dtype}, {layers} layers", rows)
    _show("  the states one token stale", [stale])
    for r in rows:
        assert sorted(r["state_err"]) == sorted(SMOKE_XLSTM_STATE_TOL)
        assert r["argmax_agree"] >= (r["rows"] if dtype == "float32" else 7)
        if dtype == "float32" and layers == 4:
            assert r["err"] <= TOL and max(r["state_err"].values()) <= TOL
        elif dtype == "float32":  # at depth f32 reassociation grows to 4.3e-5
            assert r["err"] <= SMOKE_F32_TOL
            assert all(r["state_err"][k] <= tol for k, tol in SMOKE_XLSTM_STATE_TOL.items())
    assert all(stale["state_err"][k] > tol for k, tol in SMOKE_XLSTM_STATE_TOL.items())


def test_hybrid_serve_cli(capsys):
    argv = ["--arch", "zamba2-1.2b", "--batch", "2", "--prompt-len", "16", "--new-tokens", "4"]
    assert port_serve.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "decoded 3 steps" in out and "first sequence:" in out
    assert "params=715,360 (cfg.param_count() 879,296)" in out
    if not torch.cuda.is_available():  # no card: the default device refuses
        with pytest.raises(SystemExit) as exc:
            port_serve.main(argv)
        assert exc.value.code != 0
        assert "CUDA" in capsys.readouterr().err


@pytest.mark.parametrize("arch,prompt_len,params", [
    ("deepseek-moe-16b", 24, "params=1,271,424 (cfg.param_count() 1,271,424)"),
    ("xlstm-350m", 16, "params=924,040 (cfg.param_count() 988,288)"),
])
def test_family_serve_cli(arch, prompt_len, params, capsys):
    """The README's CPU commands for the MoE and xLSTM families: the sum of
    the leaves beside ``cfg.param_count()`` (which overcounts xLSTM), and
    both listed as decode-capable."""
    argv = ["--arch", arch, "--batch", "2", "--prompt-len", str(prompt_len),
            "--new-tokens", "4", "--device", "cpu"]
    assert port_serve.main(argv) == 0
    out = capsys.readouterr().out
    assert params in out and "decoded 3 steps" in out and "first sequence:" in out
    assert port_serve.main(["--list-archs"]) == 0
    assert f"{arch}: decode" in capsys.readouterr().out


def test_serve_cli(capsys):
    argv = ["--arch", "tinyllama-1.1b", "--batch", "2", "--prompt-len", "12",
            "--new-tokens", "4"]
    assert port_serve.main(argv + ["--device", "cpu"]) == 0
    assert "first sequence:" in capsys.readouterr().out
    assert port_serve.main(["--list-archs"]) == 0
    assert "hubert-xlarge: encoder-only" in capsys.readouterr().out
    assert port_serve.main(["--arch", "hubert-xlarge"]) == 1
    llava = port_serve.serve(_args(arch="llava-next-34b", batch=1, new_tokens=2))
    assert llava["tokens"].shape == (1, 2) and llava["pos0"] == 24 + 8  # after the patches
    if not torch.cuda.is_available():  # no card: the default device refuses
        with pytest.raises(SystemExit) as exc:
            port_serve.main(argv)
        assert exc.value.code != 0
        assert "CUDA" in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-1.2b"])
def test_cache_specs_and_init_cache(arch):
    cfg = dataclasses.replace(reduced(get_config(arch)), kv_cache_dtype="int8", window=16)
    model = build_model(cfg, device="cpu")
    jspecs = jbuild(cfg).cache_specs(3, 40)
    specs = model.cache_specs(3, 40)
    for seg, jseg in zip(specs, jspecs):
        assert sorted(seg) == sorted(jseg)
        for name, (shape, dtype) in seg.items():
            assert shape == jseg[name].shape
            assert str(dtype).split(".")[1] == jseg[name].dtype.name
    cache = model.init_cache(3, 40)
    assert all(not t.any() for seg in cache for t in seg.values())
