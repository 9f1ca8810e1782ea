"""The port's decode step with the position on the device, against the
reference's compiled one; its host reads; the kept logits of ``serve``;
and (with a card) the CUDA graph against the eager step.

The reference serves through ``jax.jit(build_decode_step(model),
donate_argnums=1)`` with a traced ``jnp.int32`` position. The port's step
takes a 0-d int32 tensor and, on a card, replays one captured CUDA graph a
token (``train_step.GraphDecode``). On the CPU the step runs eagerly, the
kernels' plain versions in place of the kernels, and these tests hold:

- every serving family (reduced configs, f32, the same weights and numpy
  prompts on both sides), 8 decode steps after a prefill, the position a
  tensor: logits and every cache leaf within 1e-5 scale-normalised (int8
  leaves within one code, int8 logits within ``INT8_TOL``, as in
  ``test_torch_serve.py``), greedy tokens equal;
- no host read: a whole decode step of each family under a dispatch mode
  that fails on ``aten._local_scalar_dense``, ``aten.item``,
  ``aten.nonzero`` and boolean-mask indexing (the CPU's proxy for "a CUDA
  graph can capture it");
- ``serve(..., keep_logits=...)`` keeps copies: a step that returns one
  static logits buffer, as the graph does, must not change kept logits.

JAX is imported inside the tests that compare with it, so that the card
test runs where JAX is not installed.
"""

import argparse
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve as port_serve
from repro_torch.models.convert import load_values
from repro_torch.models.transformer import build_model
from repro_torch.train.train_step import build_decode_step, build_prefill_step

pytestmark = pytest.mark.torch_port

TOL = 1e-5
INT8_TOL = 1e-3
STEPS = 8

#: name: (arch, config changes, prompt length, max_len)
CASES = {
    "tinyllama-full": ("tinyllama-1.1b", {}, 16, 32),
    "tinyllama-window": ("tinyllama-1.1b", {"window": 16}, 24, 40),
    "tinyllama-int8": ("tinyllama-1.1b", {"kv_cache_dtype": "int8"}, 16, 32),
    "tinyllama-softcap": ("tinyllama-1.1b", {"logit_softcap": 50.0}, 16, 32),
    "zamba2-full": ("zamba2-1.2b", {}, 16, 32),
    "zamba2-window": ("zamba2-1.2b", {"window": 16}, 24, 40),
    "deepseek-moe": ("deepseek-moe-16b", {}, 16, 32),
    "xlstm": ("xlstm-350m", {}, 16, 32),
    "llava": ("llava-next-34b", {}, 8, 24),
}


def err(port, ref) -> float:
    import jax.numpy as jnp

    p = port.detach().double().numpy()
    r = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    return float(np.max(np.abs(p - r)) / (np.max(np.abs(r)) + 1e-6))


def _weights(cfg):
    """The reference's init on both sides; the sLSTM's ``r_*`` drawn
    non-zero (``init_slstm`` zeroes them)."""
    import jax
    import jax.numpy as jnp

    from repro.models import build_model as jbuild
    from repro.models import split_params

    jmodel = jbuild(cfg)
    values, _ = split_params(jmodel.init(1))
    values = jax.tree.map(np.asarray, values)
    rng = np.random.default_rng(3)
    for seg in values["segments"]:
        for name, leaf in seg.get("cell", {}).items():
            if name.startswith("r_"):
                seg["cell"][name] = (rng.normal(size=leaf.shape) / leaf.shape[-1] ** 0.5
                                     ).astype(leaf.dtype)
    model = build_model(cfg, device="cpu")
    load_values(model, values)
    return jmodel, jax.tree.map(jnp.asarray, values), model


def _inputs(cfg, prompt_len):
    rng = np.random.default_rng(2)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (2, prompt_len)).astype(np.int32)}
    if cfg.frontend == "patch":
        out["patch_embeds"] = rng.normal(
            size=(2, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return out


def _config(name):
    arch, changes, prompt_len, max_len = CASES[name]
    return dataclasses.replace(reduced(get_config(arch)), **changes), prompt_len, max_len


def _check_caches(cache, jcache, name):
    assert len(cache) == len(jcache)
    for seg, jseg in zip(cache, jcache):
        assert sorted(seg) == sorted(jseg)
        for leaf_name, leaf in seg.items():
            want = jseg[leaf_name]
            where = f"{name}: {leaf_name}"
            assert tuple(leaf.shape) == want.shape, where
            if leaf.dtype == torch.int8:
                diff = np.abs(leaf.numpy().astype(np.int32) - np.asarray(want, np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, where
            else:
                assert err(leaf.float(), want) <= TOL, where


@pytest.mark.parametrize("name", list(CASES))
def test_tensor_position_decode_matches_jitted_jax(name):
    """The port's decode step with a 0-d int32 tensor position against
    ``jax.jit(build_decode_step(model), donate_argnums=1)`` with a traced
    ``jnp.int32`` position, 8 steps after a prefill: logits, every cache
    leaf after the last step (the port's updated in place, the reference's
    donated and returned), greedy tokens."""
    import jax
    import jax.numpy as jnp

    from repro.train.train_step import build_decode_step as jbuild_decode_step
    from repro.train.train_step import build_prefill_step as jbuild_prefill_step

    cfg, prompt_len, max_len = _config(name)
    jmodel, values, model = _weights(cfg)
    inputs = _inputs(cfg, prompt_len)
    pos0 = prompt_len + (cfg.frontend_len if cfg.frontend == "patch" else 0)

    jlogits, jcache = jax.jit(jbuild_prefill_step(jmodel, max_len))(
        values, {k: jnp.asarray(v) for k, v in inputs.items()})
    logits, cache = build_prefill_step(model, max_len)(
        {k: torch.from_numpy(v) for k, v in inputs.items()})
    jdecode = jax.jit(jbuild_decode_step(jmodel), donate_argnums=1)
    decode = build_decode_step(model)
    assert decode.captured is False  # the CPU runs the step eagerly
    tol = INT8_TOL if cfg.kv_cache_dtype == "int8" else TOL
    jtok = jnp.argmax(jlogits[:, -1], -1)[:, None].astype(jnp.int32)
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    for t in range(STEPS):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        pos = torch.tensor(pos0 + t, dtype=torch.int32)
        jlogits, jcache = jdecode(values, jcache, jtok, jnp.int32(pos0 + t))
        logits, cache = decode(cache, tok, pos)
        assert err(logits, jlogits) <= tol, (name, t)
        jtok = jnp.argmax(jlogits[:, 0], -1)[:, None].astype(jnp.int32)
        tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    _check_caches(cache, jcache, name)


class NoHostRead(TorchDispatchMode):
    """Fails on every op that reads a device value back to the host or
    sizes its output by the data: what a CUDA graph cannot capture."""

    REFUSED = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.item.default,
               torch.ops.aten.nonzero.default, torch.ops.aten.masked_select.default,
               torch.ops.aten.is_nonzero.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.REFUSED:
            raise AssertionError(f"host read on the decode path: {func}")
        if func in (torch.ops.aten.index.Tensor, torch.ops.aten.index_put_.default,
                    torch.ops.aten.index_put.default):
            indices = args[1] if len(args) > 1 else kwargs.get("indices", ())
            if any(i is not None and i.dtype in (torch.bool, torch.uint8) for i in indices):
                raise AssertionError(f"boolean-mask indexing on the decode path: {func}")
        return func(*args, **kwargs)


@pytest.mark.parametrize("name", ["tinyllama-int8", "zamba2-window", "deepseek-moe", "xlstm",
                                  "llava"])
def test_decode_step_reads_nothing_back_to_the_host(name):
    """A whole decode step of each serving family, the position a tensor,
    under :class:`NoHostRead` (the int8 and ring-window caches included)."""
    cfg, prompt_len, max_len = _config(name)
    model = build_model(cfg, device="cpu").init(0)
    inputs = {k: torch.from_numpy(v) for k, v in _inputs(cfg, prompt_len).items()}
    logits, cache = build_prefill_step(model, max_len)(inputs)
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    pos = torch.tensor(prompt_len + (cfg.frontend_len if cfg.frontend == "patch" else 0),
                       dtype=torch.int32)
    decode = build_decode_step(model)
    with torch.inference_mode(), NoHostRead():
        for _ in range(2):
            logits, cache = decode(cache, tok, pos)
            pos += 1
    assert logits.shape == (2, 1, cfg.vocab_size) and bool(torch.isfinite(logits).all())


def test_no_host_read_catches_a_host_read():
    """The mode itself: an ``int()`` of a tensor and a boolean mask fail."""
    t = torch.arange(4)
    with NoHostRead(), pytest.raises(AssertionError, match="host read"):
        int(t[1])
    with NoHostRead(), pytest.raises(AssertionError, match="boolean"):
        t[t > 1]


class StaticLogitsStep:
    """The eager step behind one static logits buffer, as ``GraphDecode``
    returns its graph's: every call overwrites the same tensor."""

    def __init__(self, model):
        self.eager = build_decode_step(model)
        self.captured = False
        self.logits = None

    def __call__(self, caches, tokens, cache_pos):
        logits, caches = self.eager(caches, tokens, cache_pos)
        with torch.inference_mode():
            if self.logits is None:
                self.logits = torch.empty_like(logits)
            self.logits.copy_(logits)
        return self.logits, caches


def test_serve_keeps_copies_of_the_logits(monkeypatch):
    """``serve`` in f32 (where ``.float()`` returns its input) through a
    step with static logits keeps each step's own logits, equal to an
    eager run's."""
    cfg = reduced(get_config("tinyllama-1.1b"))
    monkeypatch.setattr(port_serve, "reduced", lambda _: cfg)
    args = argparse.Namespace(arch="tinyllama-1.1b", batch=2, prompt_len=16, new_tokens=8,
                              seed=0, full=False, list_archs=False, device="cpu")
    keep = (0, 3, 6)
    want = port_serve.serve(args, keep_logits=keep)
    monkeypatch.setattr(port_serve, "build_decode_step", StaticLogitsStep)
    got = port_serve.serve(args, keep_logits=keep)
    assert torch.equal(got["tokens"], want["tokens"])
    for t in keep:
        assert torch.equal(got["logits"][t], want["logits"][t]), t
    assert not torch.equal(got["logits"][0], got["logits"][6])


def test_cuda_graph_decode_equals_eager_decode():
    """Needs a card: tinyllama and zamba2 (reduced, f32) decoded 16 steps
    through the captured graph and through ``model.decode_step`` from the
    same prefill: tokens, logits and caches bit for bit (the same kernels
    with the same launch parameters on the same inputs), the launch count
    one step's launches a replay, and a call with other caches refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    from repro_torch.kernels.decode_attention.ops import decode_attention

    for arch in ("tinyllama-1.1b", "zamba2-1.2b"):
        cfg = reduced(get_config(arch))
        model = build_model(cfg, device="cuda").init(0)
        inputs = {"tokens": torch.from_numpy(_inputs(cfg, 16)["tokens"]).cuda()}
        runs = []
        for graph in (True, False):
            logits, cache = build_prefill_step(model, 40)(inputs)
            step = build_decode_step(model)
            assert step.captured is False
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            before, out = decode_attention.launches, []
            for t in range(16):
                if graph:
                    logits, cache = step(cache, tok, 16 + t)
                else:
                    with torch.inference_mode():
                        logits, cache = model.decode_step(cache, tok, 16 + t)
                tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
                out.append((tok.clone(), logits.clone()))
            sites = sum(1 for kind, _ in cfg.segments() if kind in ("attn_mlp", "shared_attn"))
            layers = cfg.num_layers if arch == "tinyllama-1.1b" else sites
            assert decode_attention.launches - before == 16 * layers
            if graph:
                assert step.captured and step.nodes["kernel"] > 0
                _, other = build_prefill_step(model, 40)(inputs)
                with pytest.raises(ValueError, match="other caches"):
                    step(other, tok, 16)
            runs.append((out, [{k: v.clone() for k, v in c.items()} for c in cache]))
        (g_out, g_cache), (e_out, e_cache) = runs
        for (gt, gl), (et, el) in zip(g_out, e_out):
            assert torch.equal(gt, et) and torch.equal(gl, el), arch
        for gc, ec in zip(g_cache, e_cache):
            for k in gc:
                assert torch.equal(gc[k], ec[k]), (arch, k)
