"""flash_attention in the port: plain version vs the JAX kernel, windowed
and ragged edge cases, the GQA wrapper, checks, and (with a card) the CUDA
kernel vs the plain version.

Inputs are the reference registry's (``repro.kernels.parity.make_inputs``),
moved to torch bit for bit. The JAX kernel runs in interpret mode on the
CPU, as the JAX package's own tests run it; its ``S % block`` assert is a
TPU tiling rule, so the edge cases pass it a block that divides S.
Tolerance: the registry's scale-normalised max error, f32 2e-5 and bf16
2e-2 (the kernel casts p to bf16 before the PV product; the plain version
keeps it in f32).
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import parity
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_gqa
from repro_torch.kernels.flash_attention.ref import attention_gqa_ref, attention_ref
from repro_torch.models.convert import from_numpy

pytestmark = pytest.mark.torch_port

CASES = parity.iter_cases("flash_attention")
TOLS = parity.KERNELS["flash_attention"]["tols"]


def _jax_parity():
    pytest.importorskip("jax")
    from repro.kernels import parity as jax_parity

    return jax_parity


def _to_torch(inputs):
    return [from_numpy(np.asarray(a)) for a in inputs]


def _normal(rng, shape, dtype):
    import jax.numpy as jnp

    return jnp.asarray(rng.normal(size=shape), jnp.dtype(dtype))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_plain_version_matches_jax_kernel(case):
    jax_parity = _jax_parity()
    jcase = jax_parity.KernelCase(case.kernel, case.shape, case.dtype)
    inputs = jax_parity.make_inputs(jcase)
    want = from_numpy(np.asarray(jax_parity.run_kernel(jcase, inputs, interpret=True)))
    got = flash_attention(*_to_torch(inputs), causal=case.shape[3])
    assert got.dtype == getattr(torch, case.dtype) and got.shape == want.shape
    assert parity.max_err(got, want) <= TOLS[case.dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "name,bh,s,d,causal,window,block",
    [
        # Rows >= 48 have their first 32-row kv block fully masked.
        ("window_first_block_masked", 2, 96, 32, True, 16, 32),
        ("s_not_multiple_of_64", 2, 100, 64, True, 0, 50),
        ("window_not_causal", 2, 80, 32, False, 24, 40),
        # The CUDA kernel's 128-row tiles: S one past a tile, windows at a
        # tile's width (some rows' first kv tile fully masked).
        ("s_129_window_127", 2, 129, 32, True, 127, 129),
        ("s_255_window_128_not_causal", 2, 255, 64, False, 128, 255),
        ("s_257_window_129", 1, 257, 32, True, 129, 257),
    ],
)
def test_edge_cases_match_jax_kernel(name, bh, s, d, causal, window, block, dtype):
    pytest.importorskip("jax")
    from repro.kernels.flash_attention.ops import flash_attention as jax_flash

    rng = np.random.default_rng(7)
    inputs = [_normal(rng, (bh, s, d), dtype) for _ in range(3)]
    want = from_numpy(np.asarray(jax_flash(*inputs, causal=causal, window=window,
                                           block_q=block, block_k=block, interpret=True)))
    got = flash_attention(*_to_torch(inputs), causal=causal, window=window)
    assert torch.isfinite(got.float()).all()
    assert parity.max_err(got, want) <= TOLS[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 16])
def test_gqa_wrapper_matches_jax(window, dtype):
    pytest.importorskip("jax")
    from repro.kernels.flash_attention.ops import flash_attention_gqa as jax_gqa

    rng = np.random.default_rng(8)
    b, s, h, kvh, d = 2, 48, 8, 2, 32
    q = _normal(rng, (b, s, h, d), dtype)
    k, v = (_normal(rng, (b, s, kvh, d), dtype) for _ in range(2))
    want = from_numpy(np.asarray(jax_gqa(q, k, v, causal=True, window=window,
                                         block_q=16, block_k=16, interpret=True)))
    got = flash_attention_gqa(*_to_torch((q, k, v)), causal=True, window=window)
    assert got.shape == (b, s, h, d)
    assert parity.max_err(got, want) <= TOLS[dtype]


#: A cap that the drawn logits overrun: q and k ~ N(0, 4^2) at D = 32 give
#: scaled logits of standard deviation 16, so tanh's bend decides the
#: softmax (an uncapped run misses by far more than the tolerance).
SOFTCAP = 20.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,g", [(True, 0, 1), (True, 16, 4), (False, 0, 2),
                                             (False, 12, 1)])
def test_softcap_matches_the_reference_formula(causal, window, g, dtype):
    """The GQA wrapper's plain version with ``softcap`` against the
    reference's jnp attention (``repro.models.attention._dense_attention``:
    ``cap * tanh(s / cap)`` on the f32 scaled logits, then the mask), on
    K/V expanded as the reference's ``jnp.repeat`` does."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from repro.models.attention import _dense_attention

    rng = np.random.default_rng(10)
    b, s, kvh, d = 2, 40, 2, 32
    q = _normal(rng, (b, s, kvh * g, d), dtype) * 4
    k = _normal(rng, (b, s, kvh, d), dtype) * 4
    v = _normal(rng, (b, s, kvh, d), dtype)
    cfg = SimpleNamespace(head_dim_=d, logit_softcap=SOFTCAP, causal=causal, window=window)
    want = from_numpy(np.asarray(_dense_attention(q, jnp.repeat(k, g, axis=2),
                                                  jnp.repeat(v, g, axis=2), cfg)))
    got = flash_attention_gqa(*_to_torch((q, k, v)), causal=causal, window=window,
                              softcap=SOFTCAP)
    assert parity.max_err(got, want) <= TOLS[dtype]
    uncapped = flash_attention_gqa(*_to_torch((q, k, v)), causal=causal, window=window)
    assert parity.max_err(uncapped, want) > 10 * TOLS[dtype]


def test_softcap_must_be_finite_and_not_negative():
    q = torch.randn(2, 16, 32)
    for bad in (-1.0, float("inf"), float("nan")):
        with pytest.raises(ValueError, match="softcap"):
            flash_attention(q, q, q, softcap=bad)


def test_window_of_one_attends_to_the_diagonal_only():
    """Causal with window 1: each row's only valid key is its own, so the
    output is v exactly; every earlier key of the row is masked."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 70, 32)).astype(np.float32))
               for _ in range(3))
    assert torch.equal(flash_attention(q, k, v, causal=True, window=1), v)


@pytest.mark.parametrize("wrapper", ["flash_attention", "flash_attention_gqa"])
def test_inputs_that_require_grad_raise(wrapper):
    if wrapper == "flash_attention":
        q = torch.randn(2, 16, 32)
        fn = flash_attention
    else:
        q = torch.randn(1, 16, 2, 32)
        fn = flash_attention_gqa
    for i in range(3):
        args = [q.clone() for _ in range(3)]
        args[i].requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*args)


def test_checks_dtype_shape_and_contiguity():
    q = torch.randn(2, 16, 32)
    with pytest.raises(TypeError, match="float32 or"):
        flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1), q, q)
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, q[:, :8].contiguous(), q[:, :8].contiguous())
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, window=-1)
    qg, kg = torch.randn(1, 16, 6, 32), torch.randn(1, 16, 4, 32)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_gqa(qg, kg, kg)


def test_cpu_path_runs_the_plain_version_and_counts_no_launch():
    before = flash_attention.launches
    q, k, v = (torch.randn(2, 24, 4, 32) for _ in range(3))
    k, v = k[:, :, :2].contiguous(), v[:, :, :2].contiguous()
    assert torch.equal(flash_attention_gqa(q, k, v, window=8),
                       attention_gqa_ref(q, k, v, window=8))
    assert flash_attention.launches == before


#: The CUDA kernel's tile edges: (S, window, causal, D, G); windows of
#: 127-129 leave some rows' first kv tile fully masked.
CUDA_EDGES = [(s, w, c, d, g) for s in (1, 127, 128, 129, 255, 257) for w in (0, 127, 128, 129)
              for c in (True, False) for d, g in ((32, 1), (64, 4), (128, 8))]


def test_cuda_kernel_matches_plain_version():
    """Needs a capability-9.0 card and nvcc: the kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    for case in parity.iter_cases("flash_attention"):
        inputs = parity.make_inputs(case, device="cuda")
        before = flash_attention.launches
        got = parity.run_kernel(case, inputs)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        assert parity.max_err(got, parity.run_ref(case, inputs)) <= TOLS[case.dtype], case.name
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for s, causal, window in ((96, True, 16), (100, True, 0), (80, False, 24),
                                  (130, True, 1)):
            q, k, v = (torch.randn(2, s, 32, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = attention_ref(q, k, v, causal=causal, window=window)
            assert parity.max_err(got, want) <= TOLS[str(dtype).split(".")[1]]
        q = torch.randn(2, 100, 8, 64, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(2, 100, 2, 64, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        got = flash_attention_gqa(q, k, v, causal=True, window=0)
        want = attention_gqa_ref(q, k, v, causal=True, window=0)
        assert parity.max_err(got, want) <= TOLS[str(dtype).split(".")[1]]
    for s, window, causal, d, g in CUDA_EDGES:
        for dtype in (torch.bfloat16,) + ((torch.float32,) if d == 64 else ()):
            q = torch.randn(2, s, 2 * g, d, generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn(2, s, 2, d, generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            got = flash_attention_gqa(q, k, v, causal=causal, window=window)
            want = attention_gqa_ref(q, k, v, causal=causal, window=window)
            name = f"S={s} window={window} causal={causal} D={d} G={g} {dtype}"
            assert torch.isfinite(got.float()).all(), name
            assert parity.max_err(got, want) <= TOLS[str(dtype).split(".")[1]], name
    # The softcap instantiations at the serving head dims, logits overrunning the cap.
    for (d, g), window in itertools.product(((64, 1), (128, 7)), (0, 129)):
        for dtype in (torch.float32, torch.bfloat16):
            q = (torch.randn(2, 300, 2 * g, d, generator=gen, device="cuda") * 4).to(dtype)
            k = (torch.randn(2, 300, 2, d, generator=gen, device="cuda") * 4).to(dtype)
            v = torch.randn(2, 300, 2, d, generator=gen, device="cuda").to(dtype)
            got = flash_attention_gqa(q, k, v, causal=True, window=window, softcap=50.0)
            want = attention_gqa_ref(q, k, v, causal=True, window=window, softcap=50.0)
            name = f"softcap D={d} G={g} window={window} {dtype}"
            assert parity.max_err(got, want) <= TOLS[str(dtype).split(".")[1]], name


def test_cuda_work_counters_reset_across_calls_and_graph_replays():
    """Needs a card: the bf16 kernel's persistent blocks take work items from
    counters that each launch must leave at 0, so repeated calls and CUDA
    graph replays agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(2, 1000, 8, 64, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(2, 1000, 2, 64, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    first = flash_attention_gqa(q, k, v, causal=True, window=300)
    runs = [flash_attention_gqa(q, k, v, causal=True, window=300)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_attention_gqa(q, k, v, causal=True, window=300)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_attention_gqa(q, k, v, causal=True, window=300)
    for _ in range(3):
        graph.replay()
        runs.append(out.clone())
    torch.cuda.synchronize()
    assert all(torch.equal(r, first) for r in runs)
    want = attention_gqa_ref(q, k, v, causal=True, window=300)
    assert parity.max_err(first, want) <= TOLS["bfloat16"]
