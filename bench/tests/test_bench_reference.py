"""The plain references against the program, at tiny sizes on the CPU in
f32: the same weights and batches give the same first three steps (the
references follow the program's equations), and each whole run with the
cell's own limits is correct."""

import pytest

from conftest import tiny_cell

CELLS = ["hubert-xlarge.frames2k", "zamba2-1.2b.tokens2k", "hubert-xlarge.frames512"]


@pytest.mark.parametrize("workload", CELLS)
def test_reference_follows_the_program_in_f32(workload):
    from bench import harness

    cell = tiny_cell(workload)
    res = harness.run_cell(cell, 2**31 + 77, 0.2, False, device="cpu", log=lambda *a: None)
    gaps = res["gaps"]
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-5 and gaps["change_gap"] < 1e-4
    assert res["correct"], res["checks"]
    # the window is whole epochs of the mix's records
    assert res["epochs"] >= 1
    assert res["steps"] == res["epochs"] * cell.mix["records"] // cell.mix["batch"]


def test_precision_rounds_to_float8():
    import torch

    from bench.reference.common import Precision

    x = torch.tensor([1.0, 1.0625, 3.0, 100.0])
    assert torch.equal(Precision("f32").q(x), x)
    q = Precision("fp8").q(x)
    assert q[3] == 100.0 and q[1] != x[1]          # 3 mantissa bits under one scale
    with pytest.raises(ValueError):
        Precision("int4")
