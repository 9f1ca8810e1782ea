"""The port's serving path against the JAX package's.

Reduced tinyllama (2 layers, d_model 128, 4/2 heads, head_dim 32, vocab
512) in float32 on both sides, the same weights moved across with the
bridge, the same numpy prompts: ``build_prefill_step`` then greedy
``build_decode_step``, in three variants (full cache; a 16-slot rotating
window that the 24-token prompt overfills; an int8 cache). Reduced zamba2
(4 Mamba-2 blocks, the shared attention block at 2 sites) the same way,
with a full cache and an overfilled window, every cache leaf (``ssm``,
``conv``, ``k``, ``v``) compared. Tolerance:
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
}


def _prefill_and_decode_match_jax(cfg, prompt_len, max_len):
    jmodel = jbuild(cfg)
    values, _ = split_params(jmodel.init(1))
    model = build_model(cfg, device="cpu")
    load_values(model, jax.tree.map(np.asarray, values))
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
SMOKE_STATE_TOL = {"ssm": 1e-1, "conv": 5e-2}


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
        f"ssm {r['state_err']['ssm']:.3e}, conv {r['state_err']['conv']:.3e}" for r in rows))
    for r in rows:
        if dtype == "float32":
            assert r["err"] <= TOL and r["argmax_agree"] == r["rows"]
            assert max(r["state_err"].values()) <= TOL
        else:
            assert r["err"] <= SMOKE_AGREEMENT_TOL and r["argmax_agree"] >= 7
            assert all(r["state_err"][k] <= SMOKE_STATE_TOL[k] for k in SMOKE_STATE_TOL)


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


def test_serve_cli(capsys):
    argv = ["--arch", "tinyllama-1.1b", "--batch", "2", "--prompt-len", "12",
            "--new-tokens", "4"]
    assert port_serve.main(argv + ["--device", "cpu"]) == 0
    assert "first sequence:" in capsys.readouterr().out
    assert port_serve.main(["--list-archs"]) == 0
    assert "hubert-xlarge: encoder-only" in capsys.readouterr().out
    assert port_serve.main(["--arch", "hubert-xlarge"]) == 1
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_serve.serve(_args(arch="xlstm-350m", batch=1, new_tokens=2))
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
