"""chunk_gather_train in the port: plain version vs the JAX kernel, checks,
and (with a card) the CUDA kernel vs the plain version.

Tolerance: exact. The function is integer batch assembly; the JAX kernel
runs in interpret mode on the CPU, as the JAX package's own tests run it.
JAX is imported inside the tests that use it, so that on a machine with a
card and no JAX this file still collects and the CUDA test runs.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import parity
from repro_torch.kernels.chunk_gather.ops import check_indices, chunk_gather_train
from repro_torch.kernels.chunk_gather.ref import chunk_gather_train_ref

pytestmark = pytest.mark.torch_port

CASES = parity.iter_cases()


def _jax_parity():
    pytest.importorskip("jax")
    from repro.kernels import parity as jax_parity

    return jax_parity


def _jax(ct, lens, idx, seq_len, pad_id=0):
    pytest.importorskip("jax")
    from repro.kernels.chunk_gather.ops import chunk_gather_train as jax_chunk_gather_train

    out = jax_chunk_gather_train(ct, lens, idx, seq_len=seq_len, pad_id=pad_id,
                                 interpret=True)
    return [np.asarray(o) for o in out]


def _port(ct, lens, idx, seq_len, pad_id=0):
    t = [torch.from_numpy(np.array(a, np.int32)) for a in (ct, lens, idx)]
    return [o.numpy() for o in chunk_gather_train(*t, seq_len=seq_len, pad_id=pad_id)]


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_plain_version_equals_jax_kernel_exactly(case):
    jax_parity = _jax_parity()
    inputs = jax_parity.make_inputs(jax_parity.KernelCase(case.kernel, case.shape, case.dtype))
    seq_len = case.shape[1]
    want = _jax(*inputs, seq_len)
    _assert_equal(_port(*(np.asarray(a) for a in inputs), seq_len), want)


def test_port_registry_copies_reference_shapes_inputs_and_tolerance():
    jax_parity = _jax_parity()
    ref = jax_parity.KERNELS["chunk_gather_train"]
    mine = parity.KERNELS["chunk_gather_train"]
    assert mine["shapes"] == ref["shapes"] and mine["tols"] == ref["tols"]
    for case in parity.iter_cases():
        want = jax_parity.make_inputs(
            jax_parity.KernelCase(case.kernel, case.shape, case.dtype))
        for got, w in zip(parity.make_inputs(case), want):
            np.testing.assert_array_equal(got.numpy(), np.asarray(w))


def _edge_inputs(seq_len, lens, lp, idx, seed=0):
    rng = np.random.default_rng(seed)
    ct = np.zeros((len(lens), lp), np.int32)
    for i, n in enumerate(lens):
        ct[i, :min(n, lp)] = rng.integers(1, 1000, min(n, lp))
    return ct, np.asarray(lens, np.int32), np.asarray(idx, np.int32)


@pytest.mark.parametrize(
    "name,seq_len,lens,lp,idx,pad_id",
    [
        ("duplicate_indices", 16, [5, 17, 9], 24, [2, 2, 0, 2, 1, 0], 0),
        ("len_one_and_full", 16, [1, 17, 1, 17], 24, [0, 1, 2, 3], 0),
        ("row_wider_than_seq", 12, [13, 4, 30], 40, [2, 1, 0], 0),
        ("pad_id_nonzero", 8, [3, 9], 16, [1, 0, 1], 7),
    ],
)
def test_edge_cases_match_jax(name, seq_len, lens, lp, idx, pad_id):
    ct, ln, ix = _edge_inputs(seq_len, lens, lp, idx)
    want = _jax(ct, ln, ix, seq_len, pad_id)
    _assert_equal(_port(ct, ln, ix, seq_len, pad_id), want)


def test_out_of_range_index_raises():
    ct, ln, ix = _edge_inputs(8, [3, 9], 16, [0, 2])
    with pytest.raises(IndexError, match="out of range"):
        _port(ct, ln, ix, 8)
    with pytest.raises(IndexError, match="out of range"):
        check_indices(np.asarray([-1, 0]), 2)
    check_indices(np.asarray([0, 1]), 2)


def test_checks_dtype_shape_and_contiguity():
    ct, ln, ix = (torch.from_numpy(a) for a in _edge_inputs(8, [3, 9], 16, [0, 1]))
    with pytest.raises(TypeError, match="int32"):
        chunk_gather_train(ct.long(), ln, ix, seq_len=8)
    with pytest.raises(ValueError, match="seq_len"):
        chunk_gather_train(ct, ln, ix, seq_len=16)
    with pytest.raises(ValueError, match="contiguous"):
        chunk_gather_train(ct.t().contiguous().t(), ln, ix, seq_len=8)
    with pytest.raises(ValueError, match="slots"):
        chunk_gather_train(ct, ln[:1], ix, seq_len=8)


def test_cpu_path_does_not_count_launches():
    before = chunk_gather_train.launches
    ct, ln, ix = (torch.from_numpy(a) for a in _edge_inputs(8, [3, 9], 16, [0, 1]))
    chunk_gather_train(ct, ln, ix, seq_len=8)
    assert chunk_gather_train.launches == before


@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a CUDA card (the kernel has no CPU mode)")
def test_cuda_kernel_equals_plain_version():
    """Needs a capability-9.0 card and nvcc."""
    for case in parity.iter_cases() + [parity.KernelCase("chunk_gather_train",
                                                         (8, 2048, 8), "int32")]:
        inputs = parity.make_inputs(case, device="cuda")
        before = chunk_gather_train.launches
        got = parity.run_kernel(case, inputs)
        torch.cuda.synchronize()
        assert chunk_gather_train.launches == before + 1
        want = chunk_gather_train_ref(*inputs, seq_len=case.shape[1])
        for g, w in zip(got, want):
            assert torch.equal(g, w), case.name
