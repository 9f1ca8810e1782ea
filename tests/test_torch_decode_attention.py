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
from repro_torch.kernels.common import zeroed_counters
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ops import decode_attention, query_group
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
        # Query groups the CUDA kernel sizes to G: 2, and 16 in two groups of 8.
        ("g_equals_2", (2, 4, 2, 50, 128)),
        ("g_equals_16", (2, 32, 2, 33, 32)),
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


def _reference_decode(q, ck, cv, mask, cap):
    """The reference decode's attention in jnp (``repro/models/attention.py``
    ``decode_attention_block``, lines 276-289): f32 scores scaled by
    D^-0.5, capped at ``cap * tanh(s / cap)``, masked at NEG_INF, softmax,
    probabilities in the cache dtype for the PV product."""
    import jax
    import jax.numpy as jnp

    from repro.models.attention import NEG_INF

    b, h, d = q.shape
    kvh = ck.shape[2]
    qg = q.reshape(b, 1, kvh, h // kvh, d)
    logits = jnp.einsum("bqkgd,bskd->bkgqs", qg, ck).astype(jnp.float32) * d**-0.5
    logits = logits[:, :, :, 0]
    logits = cap * jnp.tanh(logits / cap)
    logits = jnp.where(mask[:, None, None, :], logits, NEG_INF)
    probs = jax.nn.softmax(logits, axis=-1).astype(cv.dtype)
    return jnp.einsum("bkgs,bskd->bkgd", probs, cv).reshape(b, h, d)


#: As in test_torch_flash_attention.py: q and k ~ N(0, 4^2) overrun it.
SOFTCAP = 20.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 2, 40, 64), (2, 4, 4, 96, 32), (3, 14, 2, 33, 32)],
                         ids=["g4", "g1", "g7"])
def test_softcap_matches_the_reference_formula(shape, dtype):
    """The plain version with ``softcap`` against the reference decode's
    jnp formula on the same inputs (every row keeps a valid slot, where
    the reference's softmax and the kernel's zeros would differ)."""
    b, h, kvh, s, d = shape
    q, ck, cv, mask = _edge_inputs(b, h, kvh, s, d, dtype, seed=4)
    mask = mask.at[0, :3].set(True)
    q, ck = q * 4, ck * 4
    want = from_numpy(np.asarray(_reference_decode(q, ck, cv, mask, SOFTCAP)))
    args = _to_torch((q, ck, cv, mask))
    got = decode_attention(*args, softcap=SOFTCAP)
    tol = parity.KERNELS["decode_attention"]["tols"][dtype]
    assert parity.max_err(got, want) <= tol
    assert parity.max_err(decode_attention(*args), want) > 10 * tol


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
    with pytest.raises(ValueError, match="softcap"):
        decode_attention(q, ck, ck, mask, softcap=-1.0)
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


@pytest.mark.parametrize("g,want", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (8, 8),
                                    (12, 8), (16, 8)])
def test_query_group_is_the_smallest_power_of_two_up_to_8(g, want):
    assert query_group(g) == want


def test_query_group_refuses_zero():
    with pytest.raises(ValueError, match="at least one"):
        query_group(0)


@pytest.mark.parametrize(
    "blocks,s,sms,want",
    [
        (8 * 32, 4096, 132, 1),   # zamba2 decode, G = 1: 256 blocks fill the card
        (8 * 4, 2048, 132, 4),    # tinyllama decode, G = 8: one group a kv head
        (8 * 4, 512, 132, 2),     # each split keeps at least 256 rows
        (1, 100, 132, 1),         # a short cache is never split
        (2 * 2 * 2, 1000, 132, 4),
    ],
)
def test_splits_fill_the_card_only_as_far_as_needed(blocks, s, sms, want):
    assert decode_ops._splits(blocks, s, sms) == want


def test_counters_are_zeroed_once_reused_and_grown():
    """The kernels' self-resetting counters: one zeroed buffer per owner and
    device, handed out again while it is large enough, replaced by a larger
    zeroed one when it is not."""
    cpu = torch.device("cpu")
    first = zeroed_counters("test_owner", cpu, 3)
    assert first.dtype == torch.int32 and first.numel() == 3 and not first.any()
    assert zeroed_counters("test_owner", cpu, 2) is first
    assert zeroed_counters("other_owner", cpu, 2) is not first
    grown = zeroed_counters("test_owner", cpu, 5)
    assert grown.numel() >= 5 and not grown.any()
    assert zeroed_counters("test_owner", cpu, 5) is grown


def _ring_mask(b, s, start, count):
    """(B, S) validity of ``count`` ring slots from ``start``, wrapping past
    S; batch row 0 fully masked."""
    slots = (torch.arange(s, device="cuda") - start) % s
    mask = (slots < count)[None, :].expand(b, s).contiguous()
    mask[0] = False
    return mask


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
    # G = 1, 2, 4, 8, 16 with a split cache and an unsplit one, a ring mask
    # that wraps, S a multiple of no tile.
    gen = torch.Generator(device="cuda").manual_seed(5)
    for i, g in enumerate((1, 2, 4, 8, 16)):
        d = (32, 64, 128)[i % 3]
        for b, kvh, s in ((2, 2, 1000), (16, 16, 300)):
            for dtype in (torch.float32, torch.bfloat16):
                q = torch.randn(b, kvh * g, d, generator=gen, device="cuda").to(dtype)
                ck, cv = (torch.randn(b, s, kvh, d, generator=gen, device="cuda").to(dtype)
                          for _ in range(2))
                mask = _ring_mask(b, s, s - 37, s - 5)
                got = decode_attention(q, ck, cv, mask)
                want = decode_attention_plain(q, ck, cv, mask)
                tol = parity.KERNELS["decode_attention"]["tols"][str(dtype).split(".")[1]]
                name = f"G={g} {(b, kvh, s, d)} {dtype}"
                assert parity.max_err(got, want) <= tol, name
                assert not got[0].any(), name
    # The softcap instantiations at the serving head dims, scores overrunning the cap.
    for g, d in ((1, 64), (7, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            q = (torch.randn(4, 2 * g, d, generator=gen, device="cuda") * 4).to(dtype)
            ck = (torch.randn(4, 1000, 2, d, generator=gen, device="cuda") * 4).to(dtype)
            cv = torch.randn(4, 1000, 2, d, generator=gen, device="cuda").to(dtype)
            mask = _ring_mask(4, 1000, 900, 990)
            got = decode_attention(q, ck, cv, mask, softcap=50.0)
            want = decode_attention_plain(q, ck, cv, mask, softcap=50.0)
            tol = parity.KERNELS["decode_attention"]["tols"][str(dtype).split(".")[1]]
            assert parity.max_err(got, want) <= tol, f"softcap G={g} D={d} {dtype}"


def test_cuda_split_counters_reset_across_calls_and_graph_replays():
    """Needs a card: the split merge's ticket counters must be back at 0
    after every call, so repeated calls and CUDA graph replays agree bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    case = parity.KernelCase("decode_attention", (8, 32, 4, 2048, 64), "bfloat16")
    q, ck, cv, _ = parity.make_inputs(case, device="cuda")
    mask = _ring_mask(8, 2048, 100, 2000)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert decode_ops._splits(8 * 4, 2048, sms) > 1
    first = decode_attention(q, ck, cv, mask)
    runs = [decode_attention(q, ck, cv, mask)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention(q, ck, cv, mask)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention(q, ck, cv, mask)
    for _ in range(3):
        graph.replay()
        runs.append(out.clone())
    torch.cuda.synchronize()
    assert all(torch.equal(r, first) for r in runs)
