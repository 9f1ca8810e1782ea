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

import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import parity
from repro_torch.kernels.ssd_scan.ops import copy_width, ssd_scan, ssd_scan_heads
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


def _conv_slices(b, s, h, p, n, offset=0):
    """x, B and C as the model hands them over: column slices of one conv
    output (b, s, h p + 2 n) in bf16, starting ``offset`` elements in."""
    xbc = torch.zeros(b, s, offset + h * p + 2 * n, dtype=torch.bfloat16)[..., offset:]
    return (xbc[..., : h * p].reshape(b, s, h, p), xbc[..., h * p : h * p + n],
            xbc[..., h * p + n :])


@pytest.mark.parametrize("case,want", [
    ("contiguous", 16),
    ("conv slices", 16),
    ("P 20", 8),
    ("P 18, N 10", 4),
    ("size-1 dims", 16),
])
def test_copy_width_follows_addresses_and_strides(case, want):
    """16 bytes (TMA) at Zamba2's layout, 8 or 4 where P or N make rows of
    40 or 36 bytes; a dim of size 1 is never stepped, so its stride counts
    for nothing."""
    if case == "contiguous":
        xh, bm, cm = torch.zeros(2, 16, 3, 64, dtype=torch.bfloat16), *(
            torch.zeros(2, 16, 64, dtype=torch.bfloat16) for _ in range(2))
    elif case == "conv slices":
        xh, bm, cm = _conv_slices(2, 16, 4, 64, 64)
    elif case == "P 20":
        xh, bm, cm = _conv_slices(2, 16, 3, 20, 12)
    elif case == "P 18, N 10":
        xh, bm, cm = _conv_slices(2, 16, 3, 18, 10)
    else:
        xh = torch.zeros(2 * 16 * 64, dtype=torch.bfloat16).as_strided(
            (2, 16, 1, 64), (1024, 64, 7, 1))
        bm = torch.zeros(1, 16, 64, dtype=torch.bfloat16).as_strided((1, 16, 64), (3, 64, 1))
        cm = bm.clone()
    assert copy_width(xh, bm, cm) == want


def test_copy_width_refuses_odd_element_offsets():
    xh, bm, cm = _conv_slices(2, 16, 3, 64, 64, offset=1)
    with pytest.raises(ValueError, match="4-byte boundaries"):
        copy_width(xh, bm, cm)


def _cuda_heads_edges(group):
    """The bf16 kernel's edges, as ``chip_smoke.py`` phase 3 runs them: H
    of 1, G - 1, G, G + 1 and 65; S across the 64-step tile; (P, N) padded
    to 64 (20 and 12, 18 and 10 give 8- and 4-byte copies); with and
    without an initial state; contiguous and as conv-output slices."""
    heads = sorted({h for h in (1, group - 1, group, group + 1, 65) if h >= 1})
    for seed, (h, s, (p, n), init, strided) in enumerate(itertools.product(
            heads, (1, 63, 64, 65, 257), ((20, 12), (48, 40), (64, 64), (18, 10)),
            (False, True), (False, True))):
        xh, dt, a, bm, cm, s0 = (None if t is None else torch.from_numpy(t).cuda()
                                 for t in _heads_inputs(2, s, h, p, n, seed=seed, init=init))
        if strided:
            xbc = torch.cat([xh.reshape(2, s, h * p), bm, cm], dim=-1).bfloat16()
            xh, bm, cm = (xbc[..., : h * p].reshape(2, s, h, p), xbc[..., h * p : h * p + n],
                          xbc[..., h * p + n :])
        else:
            xh, bm, cm = xh.bfloat16(), bm.bfloat16(), cm.bfloat16()
        yield f"H {h} S {s} P {p} N {n} init {init} strided {strided}", (xh, dt, a, bm, cm, s0)


def test_cuda_kernel_matches_plain_version():
    """Needs a capability-9.0 card and nvcc: the kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from repro_torch.kernels.ssd_scan.ops import heads_per_block

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
    widths = set()
    for name, args in _cuda_heads_edges(heads_per_block()):
        for dtype in (torch.bfloat16, torch.float32):
            xh, dt, a, bm, cm, s0 = args
            cast = (xh.to(dtype), dt, a, bm.to(dtype), cm.to(dtype), s0)
            got = ssd_scan_heads(*cast)
            assert all(torch.isfinite(t).all() for t in got), name
            assert parity.max_err(got, ssd_scan_heads_ref(*cast)) <= TOLS["float32"], name
        widths.add(copy_width(xh, bm, cm))
    assert widths == {4, 8, 16}
    # A second call and three replays of a CUDA graph equal the first call.
    args = next(a for n, a in _cuda_heads_edges(heads_per_block()) if "H 65 S 257 P 64" in n
                and "init True strided True" in n)
    first = ssd_scan_heads(*args)
    runs = [ssd_scan_heads(*args)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ssd_scan_heads(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ssd_scan_heads(*args)
    for _ in range(3):
        graph.replay()
        runs.append(tuple(t.clone() for t in out))
    torch.cuda.synchronize()
    assert all(torch.equal(r[0], first[0]) and torch.equal(r[1], first[1]) for r in runs)
