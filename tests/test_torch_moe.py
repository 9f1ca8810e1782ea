"""The port's MoE block against the JAX package's.

Reduced deepseek-moe-16b (``configs.reduced``: d_model 128, 8 routed
experts of d_ff 256, top-2, one shared expert, capacity factor 1.25),
float32 on both sides, the reference's own init moved across as numpy,
the same numpy inputs. Tolerances: output and aux loss within 1e-5
scale-normalised (max |port - jax| / max |jax|), which f32 reassociation
stays far below at these widths; the four integer routing maps (the slot
of each assignment, the token of each slot, and both validity masks)
exactly equal, dropped assignments included. The reference builds the
maps inside ``moe_block`` with a ``jax.vmap`` of a per-row function; the
test reads them there by wrapping ``jax.vmap`` for the call.

The inputs are random f32 activations, so the router's probabilities
meet no tie, where ``lax.top_k`` and ``torch.topk`` could order two equal
experts differently.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import moe as jmoe
from repro.models.common import RngStream, split_params
from repro_torch.models import moe
from repro_torch.models.transformer import build_model

pytestmark = pytest.mark.torch_port

TOL = 1e-5


def err(port, ref) -> float:
    p = port.detach().double().numpy()
    r = np.asarray(ref, np.float64)
    return float(np.max(np.abs(p - r)) / (np.max(np.abs(r)) + 1e-6))


def _cfg(shared: bool):
    cfg = reduced(get_config("deepseek-moe-16b"))
    return cfg if shared else dataclasses.replace(cfg, moe_num_shared=0)


def _params(cfg, seed=0):
    values, _ = split_params(jmoe.init_moe(RngStream(seed), cfg, jnp.float32))
    return jax.tree.map(np.asarray, values)


def _both(tree):
    j = jax.tree.map(jnp.asarray, tree)
    t = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    return j, t


def _reference(p, x, cfg, monkeypatch):
    """The reference's output, aux and per-row routing maps."""
    maps = []
    vmap = jax.vmap

    def capturing(fn):
        mapped = vmap(fn)

        def call(*args):
            out = mapped(*args)
            maps.append(out)
            return out

        return call

    with monkeypatch.context() as m:
        m.setattr(jmoe.jax, "vmap", capturing)
        out, aux = jmoe.moe_block(p, jnp.asarray(x), cfg)
    (ref_maps,) = maps
    return out, aux, ref_maps


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("s", [32, 1])  # a prefill that drops; one decode token (cap 1)
def test_moe_block_matches_jax(shared, s, monkeypatch):
    cfg = _cfg(shared)
    values = _params(cfg, seed=1)
    jp, tp = _both(values)
    x = np.random.default_rng(2).normal(size=(4, s, cfg.d_model)).astype(np.float32)
    want, want_aux, ref_maps = _reference(jp, x, cfg, monkeypatch)
    got, aux = moe.moe_block(tp, torch.from_numpy(x), cfg)
    assert got.shape == (4, s, cfg.d_model) and aux.dtype == torch.float32
    assert err(got, want) <= TOL
    assert err(aux, want_aux) <= TOL

    cap = max(int(s * cfg.moe_top_k * cfg.capacity_factor / cfg.moe_num_experts), 1)
    _, _, top_e = moe.route(tp, torch.from_numpy(x), cfg)
    maps = moe.slot_maps(top_e.reshape(4, -1), cfg.moe_num_experts, cfg.moe_top_k, cap)
    for name, mine, ref in zip(("s2t", "s2v", "a2s", "a2v"), maps, ref_maps):
        assert tuple(mine.shape) == ref.shape, name
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref), err_msg=name)
    dropped = int((~maps[3]).sum())
    if s == 32:  # cap 10 for 64 assignments over 8 experts a row: the drop path runs
        assert cap == 10 and dropped > 0
    else:  # one token's top-k experts are distinct, so cap 1 drops nothing
        assert cap == 1 and dropped == 0


def test_later_tokens_are_dropped_first():
    """Within an expert a row's assignments keep token order, so the ones
    past capacity are the latest tokens'."""
    cfg = dataclasses.replace(_cfg(False), moe_num_experts=4, moe_top_k=1)
    flat_e = torch.tensor([[2, 0, 2, 2, 1, 2]])
    s2t, s2v, a2s, a2v = moe.slot_maps(flat_e, cfg.moe_num_experts, 1, cap=2)
    assert a2v.tolist() == [[True, True, True, False, True, False]]
    assert s2t.tolist() == [[1, 0, 4, 0, 0, 2, 0, 0]]
    assert s2v.tolist() == [[True, False, True, False, True, True, False, False]]
    assert a2s.tolist() == [[4, 0, 5, 0, 2, 0]]


def test_route_matches_jax():
    cfg = _cfg(True)
    values = _params(cfg, seed=3)
    jp, tp = _both(values)
    x = np.random.default_rng(4).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x), jp["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    want_p, want_e = jax.lax.top_k(probs, cfg.moe_top_k)
    want_p = want_p / jnp.maximum(want_p.sum(-1, keepdims=True), 1e-9)
    got_probs, got_p, got_e = moe.route(tp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    assert err(got_p, want_p) <= TOL and err(got_probs, probs) <= TOL


@pytest.mark.parametrize("shared", [True, False])
def test_init_moe_tree_matches_jax(shared):
    cfg = _cfg(shared)
    want = _params(cfg)
    got = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        if name == "shared":
            assert {k: tuple(v.shape) for k, v in leaf.items()} == {
                k: v.shape for k, v in want["shared"].items()}
        else:
            assert tuple(leaf.shape) == want[name].shape, name


def test_a2a_is_refused():
    """A model with ``moe_impl="a2a"`` builds, and its forward is refused
    without a sharding context whose mesh has a "model" axis, as the
    reference asserts (``tests/test_torch_moe_a2a.py`` runs it on one)."""
    cfg = dataclasses.replace(_cfg(True), moe_impl="a2a")
    model = build_model(cfg, device="cpu").init(0)
    with pytest.raises(RuntimeError, match="'model' axis"):
        model({"tokens": torch.zeros((1, 8), dtype=torch.int32)})
