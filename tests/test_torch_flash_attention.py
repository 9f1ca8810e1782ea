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
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import parity
from repro_torch.kernels.flash_attention.ops import (attention_flops, flash_attention,
                                                     flash_attention_gqa, kept_pairs,
                                                     train_calls)
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
def test_inputs_that_require_grad_get_the_plain_gradients(wrapper):
    """On the CPU the wrappers run the plain version under autograd: each of
    q, k and v that requires grad gets the plain version's gradient."""
    gen = torch.Generator().manual_seed(3)
    if wrapper == "flash_attention":
        shapes, fn, ref = [(2, 20, 32)] * 3, flash_attention, attention_ref
    else:
        shapes, fn, ref = [(1, 20, 4, 32), (1, 20, 2, 32), (1, 20, 2, 32)], \
            flash_attention_gqa, attention_gqa_ref
    base = [torch.randn(*sh, generator=gen) for sh in shapes]
    g = torch.randn(*shapes[0], generator=gen)
    for i in range(3):
        got_in = [t.clone().requires_grad_(j == i) for j, t in enumerate(base)]
        want_in = [t.clone().requires_grad_(j == i) for j, t in enumerate(base)]
        fn(*got_in, window=6, softcap=3.0).backward(g)
        ref(*want_in, window=6, softcap=3.0).backward(g)
        assert got_in[i].grad is not None
        assert torch.equal(got_in[i].grad, want_in[i].grad)


def test_kept_pairs_and_flops_count_the_mask():
    """The training route's FLOPs count the (query, key) pairs the mask
    keeps, against a count by hand, and 4 (forward) or 10 (backward) B H D
    a pair."""
    for s, causal, window in itertools.product((1, 7, 64, 129), (True, False), (0, 1, 5, 300)):
        want = sum((not causal or j <= i) and (not window or j > i - window)
                   for i in range(s) for j in range(s))
        assert kept_pairs(s, causal, window) == want, (s, causal, window)
    assert attention_flops((8, 2048, 16, 80), False, 0) == 4 * 8 * 16 * 80 * 2048 ** 2
    assert attention_flops((4, 4096, 32, 128), True, 0, backward=True) == \
        10 * 4 * 32 * 128 * (4096 * 4097 // 2)


def test_attention_block_takes_the_plain_path_off_the_route():
    """``attention_block`` trains through the flash kernels only on plain
    bf16 tensors on the card of a head dim they are built for
    (``flash_trains``, a predicate of what the call can see): the CPU, a
    DTensor, f32 and a head dim without a kernel (kimi's 112) keep the
    plain paths. On the CPU a training block gives the plain dense path's
    output, launching nothing."""
    from types import SimpleNamespace

    from torch.distributed.tensor import DTensor

    from repro_torch.models import attention

    bf16 = torch.bfloat16
    assert attention.flash_trains(torch.Tensor, "cuda", bf16, 64)
    assert attention.flash_trains(torch.Tensor, "cuda", bf16, 80)
    assert not attention.flash_trains(torch.Tensor, "cpu", bf16, 64)  # the CPU
    assert not attention.flash_trains(DTensor, "cuda", bf16, 64)  # the dry run
    assert not attention.flash_trains(torch.Tensor, "cuda", torch.float32, 64)
    assert not attention.flash_trains(torch.Tensor, "cuda", bf16, 112)  # no kernel at 112

    cfg = SimpleNamespace(d_model=64, num_heads=4, num_kv_heads=2, head_dim_=16, causal=True,
                          window=0, logit_softcap=0.0, attn_dense_threshold=64,
                          attn_shard="heads", rope=False)
    gen = torch.Generator().manual_seed(4)
    p = {n: torch.randn(64, 64 if n != "wk" and n != "wv" else 32, generator=gen) * 0.1
         for n in ("wq", "wk", "wv")}
    p["wo"] = torch.randn(64, 64, generator=gen) * 0.1
    x = torch.randn(2, 12, 64, generator=gen, requires_grad=True)
    before, calls = flash_attention.launches, dict(train_calls)
    out, _ = attention.attention_block(p, x, cfg)
    q, k, v = attention._project_qkv(p, x, cfg)
    want = attention._dense_attention(q, attention._expand_kv(k, cfg),
                                      attention._expand_kv(v, cfg), cfg)
    assert torch.equal(out, want.reshape(2, 12, 64) @ p["wo"])
    out.sum().backward()
    assert x.grad is not None
    assert flash_attention.launches == before and train_calls == calls


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


# ------------------------------------------------------------- training, card
#: The training kernels against the plain version in f32 under autograd:
#: scale-normalised max error of the output and of dq, dk, dv. The kernels
#: round P and dS to bf16 before their products (as the model's dense path
#: rounds the probabilities) and take delta from the bf16 output: errors of
#: a few 2^-9 (bf16's rounding) a product, 2e-3 to 6e-3 on the card,
#: against a bound of 2e-2, the bf16 forward's. dQ's partial sums are
#: added as int64 fixed point (each row in units of 2^-32 of its dO's
#: scale), whose sum does not depend on the order, so two runs agree bit
#: for bit. The log-sum-exp is f32 throughout: 1e-4.
#: The scale is the reference's largest magnitude, floored at 1e-3 (``_err``).
TRAIN_TOL = 2e-2
LSE_TOL = 1e-4

#: (B, S, H, KVH, D, causal, window, softcap): the four cells' shapes
#: (hubert's at B = 1), then the tile edges (S tails, windows that empty a
#: row's first kv tile) and softcaps.
TRAIN_CASES = ([(1, 2048, 16, 16, 80, False, 0, 0.0), (2, 512, 16, 16, 80, False, 0, 0.0),
                (1, 2048, 32, 32, 64, True, 4096, 0.0), (1, 4096, 32, 2, 128, True, 0, 0.0)]
               + [(2, s, 2 * g, 2, d, c, w, 0.0) for s in (1, 127, 129, 257)
                  for w, c in ((0, True), (0, False), (127, True), (129, True), (129, False))
                  for d, g in ((32, 1), (64, 4), (80, 1), (128, 2))]
               + [(2, 300, 2 * g, 2, d, True, w, 20.0) for d, g in ((64, 1), (128, 7))
                  for w in (0, 129)] + [(2, 300, 2, 2, 80, False, 0, 20.0)])


def _training_errors(case, gen, unit=1.0):
    """The scale-normalised errors of out, dq, dk and dv, with dO drawn at
    ``unit`` times a unit normal and the gradients read in that unit."""
    b, s, h, kvh, d, causal, window, softcap = case
    amp = 4.0 if softcap else 1.0  # logits that overrun the cap
    q = (torch.randn(b, s, h, d, generator=gen, device="cuda") * amp).bfloat16()
    k = (torch.randn(b, s, kvh, d, generator=gen, device="cuda") * amp).bfloat16()
    v = torch.randn(b, s, kvh, d, generator=gen, device="cuda").bfloat16()
    g = (torch.randn(b, s, h, d, generator=gen, device="cuda") * unit).bfloat16()
    got = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention_gqa(*got, causal=causal, window=window, softcap=softcap)
    out.backward(g)
    want = [t.float().requires_grad_() for t in (q, k, v)]
    ref = attention_gqa_ref(*want, causal=causal, window=window, softcap=softcap)
    ref.backward(g.float())
    errs = [_err(out, ref)] + [_err(a.grad.float() / unit, r.grad / unit)
                               for a, r in zip(got, want)]
    return errs, (q, k, v)


def _err(got, want):
    """``parity.max_err`` with a floor of 1e-3 under the reference's scale:
    at S = 1 dq and dk are 0 in exact arithmetic (one key: the softmax's
    gradient vanishes), and the kernel's rounding residue of ~1e-7 would
    read against the reference's 1e-6 scale instead."""
    got, want = got.detach().float(), want.detach().float()
    diff = float((got - want).abs().max())
    return diff / max(float(want.abs().max()), 1e-3) if math.isfinite(diff) else math.inf


def _lse_ref(q, k, causal, window, softcap):
    b, s, h, d = q.shape
    kk = torch.repeat_interleave(k.float(), h // k.shape[2], dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * d**-0.5
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return torch.logsumexp(torch.where(mask, logits, -torch.inf), dim=-1), mask.any(dim=1)


def test_cuda_training_kernels_match_plain_version():
    """Needs a card: the training forward (output and log-sum-exp, +inf for
    a row with no key) and the backward (dq, dk, dv) against the plain
    version in f32 under autograd, at the four cells' shapes, over the tile
    edges and with a softcap; one forward and one backward launch each; a
    second backward gives the same dq, dk and dv bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.kernels.flash_attention.ops import _launch, _launch_bwd

    gen = torch.Generator(device="cuda").manual_seed(5)
    for case in TRAIN_CASES:
        before = flash_attention.launches
        errs, (q, k, v) = _training_errors(case, gen)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 2, case
        assert max(errs) <= TRAIN_TOL, (case, errs)
        _, causal, window, softcap = case[0], case[5], case[6], case[7]
        out, lse = _launch(q, k, v, causal, window, softcap, lse=True)
        want, rows = _lse_ref(q, k, causal, window, softcap)
        assert float((lse[..., rows] - want[..., rows]).abs().max()) <= LSE_TOL, case
        assert bool(torch.isposinf(lse[..., ~rows]).all()), case
        g = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
        first = _launch_bwd(q, k, v, out, lse, g, causal, window, softcap)
        again = _launch_bwd(q, k, v, out, lse, g, causal, window, softcap)
        assert all(torch.equal(a, b) for a, b in zip(first, again)), case


@pytest.mark.parametrize("unit", [1e-9, 1e3])
def test_cuda_backward_holds_at_any_gradient_scale(unit):
    """Needs a card: with dO at 1e-9 (a mean loss's gradient over many
    tokens) or 1e3 times a unit normal, dq, dk and dv read in that unit
    match the plain version in f32 within TRAIN_TOL at hubert's and
    nemotron's head dims; and with dO times 2^-30 or 2^10 the gradients are
    exactly that power of two times those at dO, since each row's dQ unit
    follows its dO."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(6)
    two = 2.0**-30 if unit < 1 else 2.0**10
    for case in ((1, 512, 16, 16, 80, False, 0, 0.0), (1, 1024, 8, 1, 128, True, 0, 0.0)):
        errs, (q, k, v) = _training_errors(case, gen, unit)
        assert max(errs) <= TRAIN_TOL, (case, unit, errs)
        g = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
        grads = []
        for c in (1.0, two):
            got = [t.clone().requires_grad_() for t in (q, k, v)]
            flash_attention_gqa(*got, causal=case[5]).backward(g * c)
            grads.append([t.grad for t in got])
        assert all(torch.equal(a * two, b) for a, b in zip(*grads)), (case, two)


def test_cuda_training_route_in_a_captured_step():
    """Needs a card: reduced tinyllama in bf16 (D 32, 4 query heads on 2 kv
    heads) trains through the flash kernels under ``remat="dots"`` inside a
    captured ``GraphTrain`` step: ``attn.flash_calls`` on each replay's
    ``train.step`` span is two forwards (the checkpoint's recompute) and one
    backward a layer with their FLOPs; at a learning rate of 0 the eager
    step and two replays on one batch give one loss and one gradient norm,
    and two eager backward passes the same gradients, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    import dataclasses

    from repro_torch.configs import RunConfig, get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.models.common import flatten_tree
    from repro_torch.obs import tracer as trace
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.train_step import GraphTrain, build_train_step, fresh_train_state

    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    run = RunConfig(remat="dots", learning_rate=0.0, weight_decay=0.0)
    b, s = 4, 256
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    feed = {"tokens": torch.from_numpy(tokens[:, :-1]).cuda(),
            "targets": torch.from_numpy(tokens[:, 1:]).cuda(),
            "loss_mask": torch.ones(b, s, device="cuda")}
    model = build_model(cfg, device="cuda").init(0)
    opt = make_optimizer(run)
    state = fresh_train_state(model, opt)
    step = build_train_step(model, run, opt)
    assert isinstance(step, GraphTrain)
    with trace.tracing() as tracer:
        metrics = [step(state, feed)[1] for _ in range(3)]
        torch.cuda.synchronize()
        spans = [ev for ev in tracer.events() if ev[0] == "train.step"]
    layers = cfg.num_layers
    per = attention_flops((b, s, cfg.num_heads, cfg.head_dim_), cfg.causal, cfg.window)
    back = attention_flops((b, s, cfg.num_heads, cfg.head_dim_), cfg.causal, cfg.window,
                           backward=True)
    want = {"forward": 2 * layers, "backward": layers, "forward_flops": 2 * layers * per,
            "backward_flops": layers * back}
    want["flops"] = want["forward_flops"] + want["backward_flops"]
    assert [ev[5]["attn.flash_calls"] for ev in spans] == [want] * 3
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    assert losses[1] == losses[2] == losses[0]
    assert norms[1] == norms[2] == norms[0]

    leaves = list(flatten_tree(state["values"]).values())
    grads = []
    for _ in range(2):
        logits, _ = model(feed, remat="dots")
        loss = torch.nn.functional.cross_entropy(logits.float().flatten(0, 1),
                                                 feed["targets"].long().flatten())
        grads.append(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
    for g1, g2 in zip(*grads):
        assert torch.equal(g1, g2)


def test_train_step_span_carries_the_steps_flash_calls(monkeypatch):
    """The eager train step's ``train.step`` span carries ``attn.flash_calls``:
    the tally's change over the step (none on the CPU, where attention takes
    the plain path), with the FLOPs of both kinds; a tally bumped inside
    the step is counted once."""
    import dataclasses

    from repro_torch.configs import RunConfig, get_config, reduced
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import build_model
    from repro_torch.obs import tracer as trace
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import train_step as ts

    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")), num_layers=1)
    model = build_model(cfg, device="cpu").init(0)
    run = RunConfig(remat="dots")
    opt = make_optimizer(run)
    state = ts.fresh_train_state(model, opt)
    step = ts.build_train_step(model, run, opt)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32))
    feed = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:], "loss_mask": torch.ones(2, 16)}
    with trace.tracing() as tracer:
        step(state, feed)
        lm_loss = ts.lm_loss

        def bumped(*a, **kw):  # a launch queued inside the step
            ops._tally("backward", (2, 16, 4, 32), True, 0)
            return lm_loss(*a, **kw)

        monkeypatch.setattr(ts, "lm_loss", bumped)
        step(state, feed)
    spans = [ev[5]["attn.flash_calls"] for ev in tracer.events() if ev[0] == "train.step"]
    zero = {"forward": 0, "backward": 0, "forward_flops": 0, "backward_flops": 0, "flops": 0}
    back = attention_flops((2, 16, 4, 32), True, 0, backward=True)
    assert spans == [zero, dict(zero, backward=1, backward_flops=back, flops=back)]
