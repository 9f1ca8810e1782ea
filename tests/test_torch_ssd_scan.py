"""ssd_scan in the port: the plain versions vs the JAX package, checks, and
(with a card) the CUDA kernel vs the plain version.

Inputs are the reference registry's (``repro.kernels.parity.make_inputs``),
moved to torch bit for bit. The JAX kernel runs in interpret mode on the
CPU, as the JAX package's own tests run it, at the registry's quick shape;
the full grid is held to the JAX oracle ``ssd_scan_ref``. Tolerance: the
registry's scale-normalised max error, f32 2e-4 and bf16 5e-2. The
model-layout entry (shared B and C, final state) is held to the JAX model's
``_ssd_chunked`` in f32 at 1e-5: both are f32 forms of one recurrence, a
sequential one and a chunked one, and differ by reassociation only.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import parity
from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_heads
from repro_torch.kernels.ssd_scan.ref import ssd_scan_heads_ref, ssd_scan_ref
from repro_torch.models.convert import from_numpy

pytestmark = pytest.mark.torch_port

CASES = parity.iter_cases("ssd_scan")
TOLS = parity.KERNELS["ssd_scan"]["tols"]
HEADS_TOL = 1e-5


def _jax_parity():
    pytest.importorskip("jax")
    from repro.kernels import parity as jax_parity

    return jax_parity


def _to_torch(inputs):
    return [from_numpy(np.asarray(a)) for a in inputs]


def _jax_case(case):
    jax_parity = _jax_parity()
    jcase = jax_parity.KernelCase(case.kernel, case.shape, case.dtype)
    return jax_parity, jcase, jax_parity.make_inputs(jcase)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_kernel_in_interpret_mode(dtype):
    shape = _jax_parity().KERNELS["ssd_scan"]["quick_shapes"][0]
    case = parity.KernelCase("ssd_scan", shape, dtype)
    jax_parity, jcase, inputs = _jax_case(case)
    want = from_numpy(np.asarray(jax_parity.run_kernel(jcase, inputs, interpret=True)))
    got = ssd_scan(*_to_torch(inputs), chunk=shape[4])
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    assert parity.max_err(got, want) <= TOLS[dtype]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_plain_version_matches_jax_oracle(case):
    jax_parity, jcase, inputs = _jax_case(case)
    want = from_numpy(np.asarray(jax_parity.run_ref(jcase, inputs)))
    got = ssd_scan(*_to_torch(inputs), chunk=case.shape[4])
    assert got.dtype == want.dtype and got.shape == want.shape
    assert parity.max_err(got, want) <= TOLS[case.dtype]


def _heads_inputs(b, s, h, p, n, seed=0, init=False):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = (rng.random((b, s, h)) * 0.5 + 0.01).astype(np.float32)
    a = (-rng.random((h,)) * 2 - 0.1).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    s0 = rng.normal(size=(b, h, p, n)).astype(np.float32) if init else None
    return xh, dt, a, bm, cm, s0


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("s,chunk", [(48, 16), (24, 24), (40, 40)])
def test_heads_entry_matches_jax_ssd_chunked(s, chunk, init):
    """At a chunk that divides S and at chunk = S, with and without an
    initial state: y and the final state."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.models.mamba2 import _ssd_chunked as jax_ssd_chunked

    xh, dt, a, bm, cm, s0 = _heads_inputs(2, s, 3, 8, 4, seed=s, init=init)
    jy, jfinal = jax_ssd_chunked(*(jnp.asarray(t) for t in (xh, dt, a, bm, cm)), chunk,
                                 None if s0 is None else jnp.asarray(s0))
    y, final = ssd_scan_heads(*(torch.from_numpy(t) for t in (xh, dt, a, bm, cm)),
                              None if s0 is None else torch.from_numpy(s0))
    assert y.dtype == final.dtype == torch.float32
    assert y.shape == (2, s, 3, 8) and final.shape == (2, 3, 8, 4)
    assert parity.max_err(y, from_numpy(np.asarray(jy))) <= HEADS_TOL
    assert parity.max_err(final, from_numpy(np.asarray(jfinal))) <= HEADS_TOL


def test_heads_entry_reads_strided_views_and_bf16():
    """x, B and C as column slices of one conv output, in bf16 (widened to
    f32 exactly): the same numbers as contiguous f32 copies."""
    rng = np.random.default_rng(3)
    b, s, h, p, n = 2, 20, 2, 8, 4
    xbc = torch.from_numpy(rng.normal(size=(b, s, h * p + 2 * n)).astype(np.float32))
    xbc = xbc.bfloat16()
    dt = torch.from_numpy((rng.random((b, s, h)) * 0.5 + 0.01).astype(np.float32))
    a = torch.tensor([-0.5, -1.5])
    xh = xbc[..., : h * p].reshape(b, s, h, p)
    bm, cm = xbc[..., h * p : h * p + n], xbc[..., h * p + n :]
    assert not xh.is_contiguous() and not bm.is_contiguous()
    y, final = ssd_scan_heads(xh, dt, a, bm, cm)
    wy, wfinal = ssd_scan_heads_ref(xh.float().contiguous(), dt, a, bm.float().contiguous(),
                                    cm.float().contiguous())
    assert torch.equal(y, wy) and torch.equal(final, wfinal)


def test_reference_layout_is_the_heads_layout_with_one_head():
    x, dt, a, bm, cm = parity.make_inputs(parity.KernelCase("ssd_scan", (3, 40, 8, 4, 8),
                                                            "float32"))
    y, _ = ssd_scan_heads_ref(x[:, :, None], dt[:, :, None], a[:, :1], bm, cm)
    assert torch.equal(ssd_scan_ref(x, dt, a, bm, cm), y[:, :, 0])


@pytest.mark.parametrize("wrapper", ["ssd_scan", "ssd_scan_heads"])
def test_inputs_that_require_grad_raise(wrapper):
    x, dt, a, bm, cm = parity.make_inputs(parity.KernelCase("ssd_scan", (2, 16, 8, 4, 8),
                                                            "float32"))
    if wrapper == "ssd_scan_heads":
        x = x.reshape(1, 2, 16, 8).transpose(1, 2)
        dt, a, bm, cm = dt.reshape(1, 2, 16).transpose(1, 2), a[:, 0], bm[:1], cm[:1]
        fn = ssd_scan_heads
    else:
        fn = ssd_scan
    for i in range(5):
        args = [t.clone() for t in (x, dt, a, bm, cm)]
        args[i].requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*args)


def test_checks_dtypes_and_shapes():
    x, dt, a, bm, cm = parity.make_inputs(parity.KernelCase("ssd_scan", (2, 16, 8, 4, 8),
                                                            "float32"))
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        ssd_scan(x, dt, a, bm.bfloat16(), cm)
    with pytest.raises(TypeError, match="dt and a must be float32"):
        ssd_scan(x, dt.double(), a, bm, cm)
    with pytest.raises(ValueError, match="do not match"):
        ssd_scan(x, dt[:, :8], a, bm, cm)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(x, dt, a, bm, cm, chunk=0)
    xh = x.reshape(1, 2, 16, 8).transpose(1, 2)
    with pytest.raises(ValueError, match="state0"):
        ssd_scan_heads(xh, dt.reshape(1, 2, 16).transpose(1, 2), a[:, 0], bm[:1], cm[:1],
                       torch.zeros(1, 2, 8, 3))


def test_cpu_path_does_not_count_launches():
    before = ssd_scan.launches
    case = parity.KernelCase("ssd_scan", (2, 16, 8, 4, 8), "float32")
    inputs = parity.make_inputs(case)
    assert torch.equal(parity.run_kernel(case, inputs), parity.run_ref(case, inputs))
    assert ssd_scan.launches == before


def test_cuda_kernel_matches_plain_version():
    """Needs a capability-9.0 card and nvcc: the kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    for case in CASES + [parity.KernelCase("ssd_scan", (3, 100, 64, 64, 24), "float32"),
                         parity.KernelCase("ssd_scan", (2, 70, 32, 16, 1), "bfloat16")]:
        inputs = parity.make_inputs(case, device="cuda")
        before = ssd_scan.launches
        got = parity.run_kernel(case, inputs)
        torch.cuda.synchronize()
        assert ssd_scan.launches == before + 1
        assert parity.max_err(got, parity.run_ref(case, inputs)) <= TOLS[case.dtype], case.name
    xh, dt, a, bm, cm, s0 = (None if t is None else torch.from_numpy(t).cuda()
                             for t in _heads_inputs(2, 130, 4, 64, 64, init=True))
    got = ssd_scan_heads(xh.bfloat16(), dt, a, bm.bfloat16(), cm.bfloat16(), s0)
    want = ssd_scan_heads_ref(xh.bfloat16(), dt, a, bm.bfloat16(), cm.bfloat16(), s0)
    assert parity.max_err(got, want) <= TOLS["float32"]
