"""The port's Mamba-2 block against the JAX package's.

Reduced Zamba2 widths (``configs.reduced``: d_model 128, d_inner 256, 8 SSM
heads of 32, state 16, conv 4), float32 on both sides, the same numpy
weights and inputs. Tolerance: scale-normalised max error (max |port -
jax| / max |jax|) <= 1e-5, which f32 reassociation stays far below at
these widths. The prefill route scans in the ssd_scan kernel's
model-layout entry (its plain sequential version on the CPU), the training
route in the port's batched chunked scan; both are held to the reference's
chunked ``_ssd_chunked`` route, the training scan's gradients too (against
``jax.grad``), and a dispatch mode bounds the largest tensor the training
scan allocates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.configs import get_config, reduced
from repro.models import mamba2 as jmamba2
from repro_torch.models import mamba2

pytestmark = pytest.mark.torch_port

TOL = 1e-5


def err(port, ref) -> float:
    p = port.detach().double().numpy()
    r = np.asarray(ref, np.float64)
    return float(np.max(np.abs(p - r)) / (np.max(np.abs(r)) + 1e-6))


@pytest.fixture(scope="module")
def cfg():
    return reduced(get_config("zamba2-1.2b"))


def _params(cfg, seed=0):
    """Random numpy weights of one block, biases and skips non-trivial."""
    rng = np.random.default_rng(seed)
    d, di, n, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    heads = di // cfg.ssm_head_dim
    conv_dim = di + 2 * n
    f32 = np.float32
    return {
        "in_proj": (rng.normal(size=(d, 2 * di + 2 * n + heads)) / d**0.5).astype(f32),
        "conv_w": (rng.normal(size=(k, conv_dim)) * 0.1).astype(f32),
        "conv_b": (rng.normal(size=(conv_dim,)) * 0.1).astype(f32),
        "A_log": np.log(np.linspace(1.0, 16.0, heads)).astype(f32),
        "dt_bias": (rng.normal(size=(heads,)) * 0.5).astype(f32),
        "D": (1.0 + rng.normal(size=(heads,)) * 0.1).astype(f32),
        "out_proj": (rng.normal(size=(di, d)) / di**0.5).astype(f32),
    }


def _both(tree):
    j = {k: jnp.asarray(v) for k, v in tree.items()}
    t = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    return j, t


def _state(cfg, b, seed):
    rng = np.random.default_rng(seed)
    shp = mamba2.mamba2_state_shape(cfg, b)
    return {"ssm": rng.normal(size=shp["ssm"]).astype(np.float32) * 0.5,
            "conv": rng.normal(size=shp["conv"]).astype(np.float32)}


def test_state_shape_matches_jax(cfg):
    assert mamba2.mamba2_state_shape(cfg, 3) == jmamba2.mamba2_state_shape(cfg, 3)


@pytest.mark.parametrize("with_init", [False, True])
def test_causal_conv(cfg, with_init):
    rng = np.random.default_rng(1)
    c = cfg.d_inner + 2 * cfg.ssm_state
    xbc = rng.normal(size=(2, 11, c)).astype(np.float32)
    w = rng.normal(size=(cfg.ssm_conv, c)).astype(np.float32)
    b = rng.normal(size=(c,)).astype(np.float32)
    init = rng.normal(size=(2, cfg.ssm_conv - 1, c)).astype(np.float32) if with_init else None
    jout, jst = jmamba2._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b),
                                     None if init is None else jnp.asarray(init))
    out, st = mamba2._causal_conv(torch.from_numpy(xbc), torch.from_numpy(w),
                                  torch.from_numpy(b),
                                  None if init is None else torch.from_numpy(init))
    assert err(out, jout) <= TOL
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))


def _scan_inputs(b, s, h, p, n, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, p)).astype(np.float32),            # xh
            (rng.random((b, s, h)) * 0.5 + 0.01).astype(np.float32),    # dt
            (-rng.random((h,)) * 2 - 0.1).astype(np.float32),           # A
            rng.normal(size=(b, s, n)).astype(np.float32),              # B
            rng.normal(size=(b, s, n)).astype(np.float32),              # C
            rng.normal(size=(b, h, p, n)).astype(np.float32) * 0.5]     # ssm_init


@pytest.mark.parametrize("s,chunk,with_init", [
    pytest.param(32, 8, True, id="32-8"),
    pytest.param(20, None, False, id="20-None"),
    pytest.param(32, 8, False, id="32-8-no_init"),
    pytest.param(16, 16, True, id="one_chunk"),
    pytest.param(12, 32, True, id="s_below_chunk"),
])
def test_ssd_chunked(s, chunk, with_init):
    """Outputs, final state and the gradients of every input against
    ``jax.grad`` of the reference's scan, through random cotangents. A
    sequence shorter than the chunk runs as ``mamba2_block`` runs it, with
    the chunk clipped to the sequence."""
    b, h, p, n = 2, 4, 8, 16
    chunk = min(chunk or s, s)
    arrs = _scan_inputs(b, s, h, p, n)[:6 if with_init else 5]
    rng = np.random.default_rng(3)
    gy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    gf = rng.normal(size=(b, h, p, n)).astype(np.float32)

    def jloss(*t):
        y, f = jmamba2._ssd_chunked(*t[:5], chunk, t[5] if with_init else None)
        return jnp.sum(y * gy) + jnp.sum(f * gf), (y, f)

    (_, (jy, jf)), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(len(arrs))),
                                               has_aux=True)(*map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y, f = mamba2._ssd_chunked(*ts[:5], chunk, ts[5] if with_init else None)
    assert y.dtype == f.dtype == torch.float32
    assert err(y, jy) <= TOL and err(f, jf) <= TOL
    ((y * torch.from_numpy(gy)).sum() + (f * torch.from_numpy(gf)).sum()).backward()
    for name, t, jg in zip(("xh", "dt", "A", "B", "C", "ssm_init"), ts, jgrads):
        assert err(t.grad, jg) <= TOL, name
    with pytest.raises(ValueError, match="multiple"):
        mamba2._ssd_chunked(*(torch.from_numpy(a) for a in arrs[:5]), 7)


class _Allocations(TorchDispatchMode):
    """Records the storage size, in elements, of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.sizes += [(t.untyped_storage().nbytes() // t.element_size(), str(func))
                       for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        return out


def test_ssd_chunked_forms_no_p_by_chunk_product():
    """Forward and backward of the training scan allocate no tensor larger
    than b·s·h·max(chunk, p, n) elements: 16,384 at b 2, s 64, h 4, p 16,
    n 8, chunk 32. A scan that contracts (q, k, h, p) at once forms the
    (b, q, h, p, k) product, 131,072 elements a chunk here, and fails."""
    b, s, h, p, n, chunk = 2, 64, 4, 16, 8, 32
    ts = [torch.from_numpy(a).requires_grad_() for a in _scan_inputs(b, s, h, p, n)]
    mode = _Allocations()
    with mode:
        y, f = mamba2._ssd_chunked(*ts[:5], chunk, ts[5])
        (y.sum() + f.square().sum()).backward()
    assert all(t.grad is not None for t in ts)
    bound = b * s * h * max(chunk, p, n)
    biggest = max(mode.sizes)
    assert biggest[0] <= bound, biggest


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("want_cache", [False, True], ids=["train_route", "prefill_route"])
@pytest.mark.parametrize("s,chunk", [(24, None), (32, 8)])
def test_mamba2_block(cfg, want_cache, with_init, s, chunk):
    jp, tp = _both(_params(cfg))
    x = np.random.default_rng(3).normal(size=(2, s, cfg.d_model)).astype(np.float32)
    init = _state(cfg, 2, 4) if with_init else None
    jinit = None if init is None else {k: jnp.asarray(v) for k, v in init.items()}
    tinit = None if init is None else {k: torch.from_numpy(v) for k, v in init.items()}
    jout, jst = jmamba2.mamba2_block(jp, jnp.asarray(x), cfg, init_state=jinit, chunk=chunk)
    with torch.inference_mode(want_cache):
        out, st = mamba2.mamba2_block(tp, torch.from_numpy(x), cfg, init_state=tinit,
                                      chunk=chunk, want_cache=want_cache)
    assert err(out, jout) <= TOL
    assert err(st["ssm"], jst["ssm"]) <= TOL and err(st["conv"], jst["conv"]) <= TOL
    assert st["ssm"].dtype == torch.float32


def test_mamba2_block_train_route_has_gradients(cfg):
    _, tp = _both(_params(cfg))
    for v in tp.values():
        v.requires_grad_()
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 16, cfg.d_model))
                         .astype(np.float32))
    out, _ = mamba2.mamba2_block(tp, x, cfg)
    out.square().mean().backward()
    assert all(v.grad is not None and torch.isfinite(v.grad).all() for v in tp.values())
    with pytest.raises(RuntimeError, match="no backward"):
        mamba2.mamba2_block(tp, x, cfg, want_cache=True)


def test_mamba2_block_refuses_a_length_that_is_not_a_chunk_multiple(cfg):
    _, tp = _both(_params(cfg))
    x = torch.zeros(1, 12, cfg.d_model)
    with torch.inference_mode(), pytest.raises(ValueError, match="multiple"):
        mamba2.mamba2_block(tp, x, cfg, chunk=8, want_cache=True)


def test_mamba2_decode_updates_the_state_in_place(cfg):
    jp, tp = _both(_params(cfg, seed=6))
    x = np.random.default_rng(7).normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    st = _state(cfg, 3, 8)
    jout, jst = jmamba2.mamba2_decode(jp, jnp.asarray(x), {k: jnp.asarray(v)
                                                           for k, v in st.items()}, cfg)
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    ptrs = {k: v.data_ptr() for k, v in tst.items()}
    out, new = mamba2.mamba2_decode(tp, torch.from_numpy(x), tst, cfg)
    assert err(out, jout) <= TOL
    for k in ("ssm", "conv"):
        assert new[k].data_ptr() == ptrs[k]
        assert err(new[k], jst[k]) <= TOL


def test_decode_continues_the_prefill(cfg):
    """Prefill of S tokens, then one decode step, equals a prefill of S + 1
    tokens at its last position, in the port alone (f32)."""
    _, tp = _both(_params(cfg, seed=9))
    x = torch.from_numpy(np.random.default_rng(10).normal(size=(2, 17, cfg.d_model))
                         .astype(np.float32))
    with torch.inference_mode():
        _, st = mamba2.mamba2_block(tp, x[:, :16], cfg, want_cache=True)
        out, _ = mamba2.mamba2_decode(tp, x[:, 16:], st, cfg)
        full, fst = mamba2.mamba2_block(tp, x, cfg, want_cache=True)
    assert err(out, full[:, 16:].numpy()) <= TOL
    assert err(st["ssm"], fst["ssm"].numpy()) <= TOL
    assert err(st["conv"], fst["conv"].numpy()) <= TOL  # GEMMs of other shapes
