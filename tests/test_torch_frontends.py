"""The frontend stubs against the JAX package: llava's ``patch`` and hubert's ``frame``.

Reduced llava-next-34b (2 layers, d_model 128, 4/2 heads of 32, vocab
512; 8 patches of width 32 before the tokens) and reduced hubert-xlarge
(the same widths, 4/4 heads, non-causal; frames of width 32 in place of
the tokens), float32 on both sides, the same weights moved across with the
bridge, the same numpy inputs. Tolerance: scale-normalised max error (max
|port - jax| / max |jax|) <= 1e-5, and greedy tokens equal.
"""

import argparse
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
from repro.train.train_step import build_decode_step as jbuild_decode_step
from repro.train.train_step import build_prefill_step as jbuild_prefill_step
from repro.train.train_step import build_train_step as jbuild_train_step
from repro_torch.checkpoint import ckpt
from repro_torch.launch import serve as port_serve
from repro_torch.models.common import flatten_tree
from repro_torch.models.convert import load_values, to_numpy, values_to_numpy
from repro_torch.models.transformer import build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.train_step import build_decode_step, build_prefill_step, fresh_train_state

pytestmark = pytest.mark.torch_port

TOL = 1e-5
ARCHS = ["llava-next-34b", "hubert-xlarge"]
#: The decode-vs-prefill bounds of ``chip_smoke.py`` phase 11c (bf16):
#: scale-normalised error, and argmax equal on all rows but one.
SMOKE_AGREEMENT_TOL = 5e-2


def err(got, want) -> float:
    g = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(g, np.float64) - w)) / (np.max(np.abs(w)) + 1e-12))


def _values(cfg, seed=0):
    """JAX-initialised weights as numpy, the norm scales (0 at init) drawn
    non-zero."""
    values = jax.tree.map(np.asarray, split_params(jbuild(cfg).init(seed))[0])
    rng = np.random.default_rng(seed + 1)
    seg = values["segments"][0]
    for name in ("ln1", "ln2"):
        seg[name] = rng.uniform(-0.2, 0.2, seg[name].shape).astype(np.float32)
    values["final_norm"] = rng.uniform(-0.2, 0.2, values["final_norm"].shape).astype(np.float32)
    return values


def _inputs(cfg, b=2, s=16, seed=3) -> dict:
    """Numpy model inputs: tokens and patch embeddings (patch), or frames
    (frame), with targets and a loss mask over every position."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.frontend == "frame":
        out = {"frames": rng.normal(size=(b, s, cfg.frontend_dim)).astype(np.float32)}
        n = s
    else:
        out = {"tokens": tokens,
               "patch_embeds": rng.normal(size=(b, cfg.frontend_len, cfg.frontend_dim)
                                          ).astype(np.float32)}
        n = cfg.frontend_len + s
    out["targets"] = rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32)
    out["loss_mask"] = (rng.random((b, n)) < 0.8).astype(np.float32)
    return out


def _port_model(cfg, values):
    model = build_model(cfg, device="cpu")
    load_values(model, values)
    return model


def _torch(batch) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _flat_jax(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = np.asarray(leaf)
    return out


@pytest.mark.parametrize("remat", ["none", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_forward_logits(arch, remat):
    """Logits of the training route: the patches projected through the
    ``frontend`` leaf and put before the tokens (llava, causal over both),
    or the frames projected in place of the tokens (hubert, non-causal)."""
    cfg = reduced(get_config(arch))
    values = _values(cfg)
    inputs = _inputs(cfg)
    feed = {k: v for k, v in inputs.items() if k in ("tokens", "patch_embeds", "frames")}
    want, _, _ = jbuild(cfg).forward(jax.tree.map(jnp.asarray, values),
                                     jax.tree.map(jnp.asarray, feed))
    got, _ = _port_model(cfg, values)(_torch(feed), remat=remat)
    n = inputs["targets"].shape[1]
    assert got.shape == (2, n, cfg.vocab_size) == want.shape
    assert err(got, want) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_tree_and_param_count(arch):
    """The ``frontend`` leaf sits at the tree's top level, (frontend_dim,
    d_model), so the state-dict names are the reference's tree paths and
    ``cfg.param_count()`` equals the sum of the leaves (the reference's
    ``test_param_count_formula_matches_dense``); the port's own init fills
    it from N(0, 1/frontend_dim)."""
    cfg = reduced(get_config(arch))
    model = build_model(cfg, device="cpu")
    jvalues = _values(cfg)
    names = {k.replace(".", "/") for k in model.state_dict()}
    assert names == set(flatten_tree(jvalues)) and "frontend" in names
    assert tuple(model.frontend.shape) == jvalues["frontend"].shape == (cfg.frontend_dim,
                                                                        cfg.d_model)
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    model.init(0)
    std = float(model.frontend.detach().std())
    assert abs(std * cfg.frontend_dim**0.5 - 1.0) < 0.1


def test_frame_arch_never_reads_the_token_embedding():
    """hubert's forward takes frames alone; its token embedding gets a zero
    gradient, as ``jax.grad`` gives the reference's unread leaf."""
    from repro_torch.train.losses import lm_loss

    cfg = reduced(get_config("hubert-xlarge"))
    model = _port_model(cfg, _values(cfg))
    batch = _torch(_inputs(cfg))
    logits, _ = model({"frames": batch["frames"]})
    loss = lm_loss(logits, batch["targets"], batch["loss_mask"])[0]
    params = flatten_tree(model.values())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                 allow_unused=True, materialize_grads=True)))
    assert not grads["embed"].any() and grads["frontend"].abs().sum() > 0


@pytest.mark.parametrize("path", ["naive", "stage", "gather"])
@pytest.mark.parametrize("arch,optimizer", [("llava-next-34b", "adamw"),
                                            ("hubert-xlarge", "adafactor")])
def test_trainer_step_matches_jax(arch, optimizer, path, tmp_path, monkeypatch):
    """One step of ``repro_torch.launch.train`` on each device path: the
    stub feed it builds after staging equals the reference launcher's feed
    built from the same host batch (one-hot frames of ``tokens %
    frontend_dim``; zero patches, and targets and loss mask with
    ``frontend_len`` leading zeros), and the loss and every parameter after
    the step match the reference's train step from the same weights."""
    import repro_torch.launch.train as port_train
    from repro_torch.core import ChunkStore, RedoxLoader

    cfg = reduced(get_config(arch))
    seen = {}
    init = port_train.init_train_state

    def capture(model, opt, seed=0):
        state = init(model, opt, seed)
        seen["model"], seen["values"] = model, values_to_numpy(model)
        return state

    monkeypatch.setattr(port_train, "init_train_state", capture)
    args = port_train.parse_args([
        "--arch", arch, "--device", "cpu", "--steps", "1", "--device-path", path,
        "--num-docs", "64", "--seq-len", "16", "--batch", "4", "--optimizer", optimizer,
        "--workdir", str(tmp_path)])
    feeds = []
    summary = port_train.train(args, on_batch=lambda step, feed: feeds.append(
        {k: v.clone() for k, v in feed.items()}))
    (feed,) = feeds

    store = ChunkStore.open(tmp_path / "chunks")
    host = next(iter(RedoxLoader.from_spec(summary["spec"], store).epoch(0)))
    store.close()
    # The reference launcher's stub feed (repro/launch/train.py), from the host batch.
    jfeed = {k: jnp.asarray(host[k]) for k in ("tokens", "targets", "loss_mask")}
    if cfg.frontend == "frame":
        jfeed["frames"] = jax.nn.one_hot(jfeed.pop("tokens") % cfg.frontend_dim,
                                         cfg.frontend_dim, dtype=jnp.float32)
    else:
        b, p = jfeed["tokens"].shape[0], cfg.frontend_len
        jfeed["patch_embeds"] = jnp.zeros((b, p, cfg.frontend_dim), jnp.float32)
        jfeed["targets"] = jnp.concatenate([jnp.zeros((b, p), jnp.int32), jfeed["targets"]], 1)
        jfeed["loss_mask"] = jnp.concatenate(
            [jnp.zeros((b, p), jnp.float32), jfeed["loss_mask"]], 1)
    assert sorted(feed) == sorted(jfeed)
    for k in jfeed:
        np.testing.assert_array_equal(feed[k].numpy(), np.asarray(jfeed[k]), err_msg=k)

    run = RunConfig(optimizer=optimizer, remat="dots")
    jopt = jmake_optimizer(run)
    jvalues = jax.tree.map(jnp.asarray, seen["values"])
    jstate = {"values": jvalues, "opt": jopt.init(jvalues), "step": jnp.zeros((), jnp.int32)}
    jstate, jm = jax.jit(jbuild_train_step(jbuild(cfg), run, jopt))(jstate, jfeed)
    assert err(summary["losses"][0], float(jm["loss"])) <= TOL
    want = _flat_jax(jstate["values"])
    got = {k: to_numpy(v) for k, v in flatten_tree(seen["model"].values()).items()}
    before = _flat_jax(seen["values"])
    assert want.keys() == got.keys()
    for k in want:
        assert_updates_match(got[k] - before[k], want[k] - before[k], k)
        if before[k].any():  # a zero-initialised norm scale is all update
            assert err(got[k], want[k]) <= TOL, k


#: The update bounds of ``tests/test_torch_train.py``: the updates (new -
#: old), normalised by the largest, may differ by more than 1e-3 in at most
#: 0.1% of the entries and by 0.1 in none. AdamW and Adafactor normalise
#: each gradient entry, which turns the f32 rounding of a small, cancelling
#: entry into a visible change of that entry's update (hubert's zero-init
#: ``ln2`` under Adafactor: 2.2e-5 of the largest update).
DELTA_ENTRY_TOL, DELTA_FRAC, DELTA_MAX = 1e-3, 1e-3, 0.1


def assert_updates_match(got, want, key):
    scale = np.max(np.abs(want)) + 1e-30
    rel = np.abs(np.asarray(got, np.float64) - want) / scale
    assert rel.max() <= DELTA_MAX, (key, rel.max())
    assert np.mean(rel > DELTA_ENTRY_TOL) <= DELTA_FRAC, (key, np.mean(rel > DELTA_ENTRY_TOL))


def _serve_args(**kw):
    base = dict(arch="llava-next-34b", batch=2, prompt_len=8, new_tokens=4, seed=0,
                full=False, list_archs=False, device="cpu")
    return argparse.Namespace(**{**base, **kw})


#: Serving cases: (prompt_len, new_tokens). The prefill is frontend_len (8)
#: + prompt_len long and the cache holds prompt_len + new_tokens slots, as
#: in the reference: "ring" overfills it (16 into 12); in "fits" the
#: prefill fits (16 into 20), and decode from step 4 (position 20) writes
#: over the oldest patches, since frontend_len + prompt_len + new_tokens
#: positions never fit.
SERVE_CASES = {"ring": (8, 4), "fits": (8, 12)}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_serve_llava_matches_jax(case):
    """``serve`` on reduced llava against the reference serve loop
    (``repro/launch/serve.py``: zero patches, ``pos0 = prompt_len +
    frontend_len``) on the port's weights: greedy tokens equal, the
    prefill's and every decode step's logits within TOL."""
    prompt_len, new = SERVE_CASES[case]
    steps = tuple(range(new - 1))
    summary = port_serve.serve(_serve_args(prompt_len=prompt_len, new_tokens=new),
                               keep_logits=steps)
    cfg = summary["model"].cfg
    assert summary["pos0"] == prompt_len + cfg.frontend_len
    assert tuple(summary["extra"]["patch_embeds"].shape) == (2, cfg.frontend_len,
                                                             cfg.frontend_dim)
    jmodel = jbuild(cfg)
    values = jax.tree.map(jnp.asarray, values_to_numpy(summary["model"]))
    max_len = prompt_len + new
    inputs = {"tokens": jnp.asarray(summary["prompts"].numpy()),
              "patch_embeds": jnp.zeros((2, cfg.frontend_len, cfg.frontend_dim), jnp.float32)}
    logits, cache = jax.jit(jbuild_prefill_step(jmodel, max_len))(values, inputs)
    assert cache[0]["k"].shape[2] == max_len
    assert err(summary["prefill_logits"], logits[:, -1]) <= TOL
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    out = [tok]
    decode = jax.jit(jbuild_decode_step(jmodel))
    pos0 = prompt_len + cfg.frontend_len
    for t in steps:
        logits, cache = decode(values, cache, tok, jnp.int32(pos0 + t))
        assert err(summary["logits"][t], logits[:, 0]) <= TOL, t
        tok = jnp.argmax(logits[:, 0], -1)[:, None].astype(jnp.int32)
        out.append(tok)
    np.testing.assert_array_equal(summary["tokens"].numpy(), np.concatenate(out, 1))


def test_llava_ring_cache_drops_the_patches():
    """By the reference's rule the cache holds ``prompt_len + new_tokens``
    slots, fewer than the ``frontend_len + prompt_len + new_tokens``
    positions of a patch run, so decode attends only the last positions: a
    fresh prefill (which sees the patches) differs from decode by design
    once the ring has turned, whether the prefill overfilled it ("ring")
    or decode did ("fits", step 10). With ``new_tokens`` raised by
    ``frontend_len`` the cache holds every position and the two agree to
    reassociation."""
    rows = {}
    for case, (prompt_len, new) in {**SERVE_CASES, "holds-all": (8, 12 + 8)}.items():
        steps = (0, 10) if new > 4 else (0, 2)
        summary = port_serve.serve(_serve_args(prompt_len=prompt_len, new_tokens=new),
                                   keep_logits=steps)
        rows[case] = port_serve.prefill_agreement(summary, steps)
    assert all(r["err"] <= TOL and r["argmax_agree"] == r["rows"] for r in rows["holds-all"])
    assert rows["fits"][0]["err"] <= TOL  # step 0: nothing overwritten yet
    assert rows["fits"][1]["err"] > 100 * TOL
    assert min(r["err"] for r in rows["ring"]) > 100 * TOL


def _stale_reading(summary, t: int) -> dict:
    """Decode step ``t`` against a cache whose token ``t - 1`` K/V was never
    written (zero in every layer), held to the same fresh prefill."""
    model = summary["model"]
    p, pos0 = summary["prompts"].shape[1], summary["pos0"]
    seq = torch.cat([summary["prompts"], summary["tokens"][:, :t + 1]], dim=1)
    _, cache = build_prefill_step(model, summary["max_len"])(
        {"tokens": seq[:, :-1], **summary["extra"]})
    with torch.inference_mode():
        for entry in cache:
            entry["k"][:, :, pos0 + t - 1] = 0
            entry["v"][:, :, pos0 + t - 1] = 0
    logits, _ = build_decode_step(model)(cache, seq[:, -1:], pos0 + t)
    (row,) = port_serve.prefill_agreement({**summary, "logits": {t: logits[:, 0].float()}},
                                          (t,))
    assert p + t + 1 == seq.shape[1]
    return row


def test_llava_bf16_decode_matches_fresh_prefill(monkeypatch):
    """The check ``chip_smoke.py`` phase 11c makes at full width, here at
    reduced widths with llava's depth (60 layers), query group (56/8 heads,
    G = 7) and head dim (128), in bf16, with a cache that holds the patches
    (8 + 8 + 12 slots): decode against a fresh prefill at four steps, and
    the planted fault, token t - 1's K/V zeroed. The errors print with
    ``-s``; the sound ones must lie within the smoke's bounds."""
    cfg = dataclasses.replace(reduced(get_config("llava-next-34b")), num_layers=60,
                              num_heads=14, num_kv_heads=2, head_dim=128,
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    monkeypatch.setattr(port_serve, "reduced", lambda _: cfg)
    steps = (0, 4, 7, 10)
    summary = port_serve.serve(_serve_args(batch=8, prompt_len=8, new_tokens=12 + 8),
                               keep_logits=steps)
    rows = port_serve.prefill_agreement(summary, steps)
    stale = _stale_reading(summary, steps[-1])
    print("bf16, 60 layers, G = 7: " + "; ".join(
        f"step {r['step']}: err {r['err']:.3e}, argmax {r['argmax_agree']}/{r['rows']}"
        for r in rows) + f"; stale cache at step {stale['step']}: err {stale['err']:.3e}")
    for r in rows:
        assert r["err"] <= SMOKE_AGREEMENT_TOL and r["argmax_agree"] >= r["rows"] - 1
    assert stale["err"] > max(r["err"] for r in rows)


def test_serve_refuses_the_encoder(capsys):
    """hubert is encoder-only: ``serve`` exits 1, ``--list-archs`` says so,
    and llava is listed as decode-capable."""
    assert port_serve.main(["--arch", "hubert-xlarge", "--device", "cpu"]) == 1
    assert "hubert-xlarge is encoder-only" in capsys.readouterr().out
    with pytest.raises(ValueError, match="encoder-only"):
        port_serve.serve(_serve_args(arch="hubert-xlarge"))
    assert port_serve.main(["--list-archs"]) == 0
    out = capsys.readouterr().out
    assert "hubert-xlarge: encoder-only" in out and "llava-next-34b: decode" in out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_leaf_crosses_convert_and_checkpoint(arch, dtype, tmp_path):
    """The ``frontend`` leaf moves bit for bit through the weights bridge
    both ways, and through the shared checkpoint format both ways."""
    cfg = dataclasses.replace(reduced(get_config(arch)), param_dtype=dtype,
                              compute_dtype=dtype)
    values = jax.tree.map(np.asarray, split_params(jbuild(cfg).init(4))[0])
    model = _port_model(cfg, values)
    back = values_to_numpy(model)

    def bits(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 or a.dtype.kind == "V" else a

    np.testing.assert_array_equal(bits(back["frontend"]), bits(values["frontend"]))
    # port -> reference
    run = RunConfig()
    state = fresh_train_state(model, make_optimizer(run))
    ckpt.save_checkpoint(tmp_path / "port", 3, state)
    jvalues = jax.tree.map(jnp.asarray, values)
    like = {"values": jax.tree.map(jnp.zeros_like, jvalues),
            "opt": jax.tree.map(jnp.zeros_like, jmake_optimizer(run).init(jvalues)),
            "step": jnp.zeros((), jnp.int32)}
    restored = jckpt.restore_checkpoint(tmp_path / "port", 3, like)
    np.testing.assert_array_equal(bits(restored["values"]["frontend"]), bits(values["frontend"]))
    # reference -> port
    jckpt.save_checkpoint(tmp_path / "jax", 3, {**restored, "step": jnp.asarray(3, jnp.int32)})
    fresh = fresh_train_state(build_model(cfg, device="cpu").init(9), make_optimizer(run))
    ckpt.restore_checkpoint(tmp_path / "jax", 3, fresh)
    np.testing.assert_array_equal(to_numpy(fresh["values"]["frontend"]).view(np.uint16)
                                  if dtype == "bfloat16" else to_numpy(fresh["values"]["frontend"]),
                                  bits(values["frontend"]))
    assert int(fresh["step"]) == 3
