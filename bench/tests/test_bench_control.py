"""The comparison that decides ``correct`` fails what it must: the control
(the reference in the program's place with float8 products) and a run of
the harness with the timed path broken underneath, once for each fault a
training cell can have on one chip. At tiny sizes on the CPU, with each
cell's own limits."""

import contextlib

import pytest

from conftest import tiny_cell

CELLS = ["hubert-xlarge.frames2k", "zamba2-1.2b.tokens2k", "hubert-xlarge.frames512"]
SEED = 2**31 + 101


def _over(gaps, limits):
    return [k for k in ("loss_gap", "grad_gap", "change_gap") if gaps[k] > limits[k]]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    import torch

    from bench import control, harness

    cell = tiny_cell(workload, "bfloat16")
    first, _ = control.program_readings(harness, cell, SEED, torch.device("cpu"))
    ref = harness.reference_readings(cell, SEED, first["batches"], "cpu")
    low = harness.reference_readings(cell, SEED, first["batches"], "cpu", "fp8")
    assert _over(harness.model_gaps(low, ref), cell.limits)


@contextlib.contextmanager
def _state_unchanged(monkeypatch):
    """Every step returns its state unchanged: the optimizer updates nothing."""
    from repro_torch.optim import optimizers

    real = optimizers.make_optimizer

    def frozen(run):
        opt = real(run)
        return optimizers.Optimizer(opt.init, lambda *a: None, opt.state_axes)

    monkeypatch.setattr(optimizers, "make_optimizer", frozen)
    yield


@contextlib.contextmanager
def _half_batch(monkeypatch):
    """Half of each batch left out, the loss the mean over the rest."""
    from repro_torch.launch import train

    real = train._feed

    def half(batch, device, cfg):
        feed = real(batch, device, cfg)
        mask = feed["loss_mask"].clone()
        mask[mask.shape[0] // 2:] = 0
        return dict(feed, loss_mask=mask)

    monkeypatch.setattr(train, "_feed", half)
    yield


@contextlib.contextmanager
def _token_altered(monkeypatch):
    from bench import control

    with control.token_altered():
        yield


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered],
                         ids=["state_unchanged", "half_batch", "token_altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    from bench import harness

    cell = tiny_cell(workload)
    with fault(monkeypatch):
        res = harness.run_cell(cell, SEED, 0.2, False, device="cpu", log=lambda *a: None)
    assert not res["correct"], res["checks"]
