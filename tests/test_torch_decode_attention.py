"""decode_attention in the port: plain version vs the JAX kernel, edge
cases, checks, and (with a card) the CUDA kernel vs the plain version.

Inputs are the reference registry's (``repro.kernels.parity.make_inputs``),
moved to torch bit for bit. The JAX kernel runs in interpret mode on the
CPU, as the JAX package's own tests run it. Tolerance: the registry's
scale-normalised max error, f32 2e-5 and bf16 2e-2 (the kernel casts p to
bf16 before the PV product; the plain version keeps it in f32).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import parity
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_plain
from repro_torch.models.convert import from_numpy

pytestmark = pytest.mark.torch_port

CASES = parity.iter_cases("decode_attention")


def _jax_parity():
    pytest.importorskip("jax")
    from repro.kernels import parity as jax_parity

    return jax_parity


def _jax_decode(inputs, block_k):
    pytest.importorskip("jax")
    from repro.kernels.decode_attention.ops import decode_attention as jax_decode

    return from_numpy(np.asarray(jax_decode(*inputs, block_k=block_k, interpret=True)))


def _to_torch(inputs):
    return [from_numpy(np.asarray(a)) for a in inputs]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_plain_version_matches_jax_kernel(case):
    jax_parity = _jax_parity()
    jcase = jax_parity.KernelCase(case.kernel, case.shape, case.dtype)
    inputs = jax_parity.make_inputs(jcase)
    want = from_numpy(np.asarray(jax_parity.run_kernel(jcase, inputs, interpret=True)))
    got = decode_attention(*_to_torch(inputs))
    assert got.dtype == getattr(torch, case.dtype) and got.shape == want.shape
    tol = parity.KERNELS["decode_attention"]["tols"][case.dtype]
    assert parity.max_err(got, want) <= tol


def _edge_inputs(b, h, kvh, s, d, dtype, seed=0):
    """Reference-style draws; batch row 0 fully masked."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    dt = jnp.dtype(dtype)
    q = jnp.asarray(rng.normal(size=(b, h, d)), dt)
    ck = jnp.asarray(rng.normal(size=(b, s, kvh, d)), dt)
    cv = jnp.asarray(rng.normal(size=(b, s, kvh, d)), dt)
    mask = rng.random((b, s)) < 0.75
    mask[0] = False
    return q, ck, cv, jnp.asarray(mask)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "name,shape",
    [
        ("s_not_multiple_of_128", (2, 8, 2, 40, 64)),
        ("g_equals_1", (2, 4, 4, 96, 32)),
        ("g_equals_8", (3, 32, 4, 72, 64)),
    ],
)
def test_edge_cases_match_jax_kernel(name, shape, dtype):
    pytest.importorskip("jax")
    inputs = _edge_inputs(*shape, dtype)
    s = shape[3]
    want = _jax_decode(inputs, block_k=s)  # one block: any S runs interpreted
    got = decode_attention(*_to_torch(inputs))
    assert parity.max_err(got, want) <= parity.KERNELS["decode_attention"]["tols"][dtype]
    # Batch row 0 has no valid slot: exactly zeros, no NaN.
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got[0].float(), torch.zeros_like(got[0].float()))
    assert torch.equal(want[0].float(), torch.zeros_like(want[0].float()))


def test_checks_dtype_shape_contiguity_and_grad():
    q = torch.randn(2, 8, 32)
    ck = torch.randn(2, 16, 2, 32)
    mask = torch.ones(2, 16, dtype=torch.bool)
    with pytest.raises(TypeError, match="bool"):
        decode_attention(q, ck, ck, mask.int())
    with pytest.raises(TypeError, match="differ"):
        decode_attention(q, ck.bfloat16(), ck.bfloat16(), mask)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        decode_attention(q.half(), ck.half(), ck.half(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(q, ck.transpose(1, 2).contiguous().transpose(1, 2), ck, mask)
    with pytest.raises(ValueError, match="mask"):
        decode_attention(q, ck, ck, mask[:, :8].contiguous())
    with pytest.raises(ValueError, match="multiple"):
        decode_attention(torch.randn(2, 7, 32), ck, ck, mask)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention(q.requires_grad_(), ck, ck, mask)


def test_cpu_path_runs_the_plain_version_and_counts_no_launch():
    before = decode_attention.launches
    rng = np.random.default_rng(3)
    q, ck, cv = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 for s in ((2, 4, 32), (2, 24, 2, 32), (2, 24, 2, 32)))
    mask = torch.from_numpy(rng.random((2, 24)) < 0.5)
    assert torch.equal(decode_attention(q, ck, cv, mask), decode_attention_plain(q, ck, cv, mask))
    assert decode_attention.launches == before


def test_cuda_kernel_matches_plain_version():
    """Needs a capability-9.0 card and nvcc: the kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    extra = [parity.KernelCase("decode_attention", shape, dtype)
             for shape in ((8, 32, 4, 2048, 64), (2, 8, 2, 40, 64), (2, 4, 4, 96, 32))
             for dtype in ("float32", "bfloat16")]
    for case in parity.iter_cases("decode_attention") + extra:
        inputs = parity.make_inputs(case, device="cuda")
        inputs[3][0] = False  # one fully masked row
        before = decode_attention.launches
        got = parity.run_kernel(case, inputs)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        want = parity.run_ref(case, inputs)
        tol = parity.KERNELS["decode_attention"]["tols"][case.dtype]
        assert parity.max_err(got, want) <= tol, case.name
        assert not got[0].any(), case.name
