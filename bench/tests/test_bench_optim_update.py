"""``bench/metrics/optim.update_roofline.py`` on hand-made contexts: the
bytes that the ``train.step`` spans' ``optim.update_bytes`` carry over
3.35 TB/s, against the traced time of the ``optim_`` kernels, and nothing
where the tally or the kernels are missing."""

import types

import pytest

from bench import harness

READ = harness._metric_reader("optim.update_roofline")


def _ctx(tallies, kernels):
    spans = [("train.step", "compute", 0.0, 1.0, 0,
              None if t is None else {"optim.update_bytes": t}) for t in tallies]
    spans.append(("train.feed", "data", 0.0, 0.1, 0, {}))
    return types.SimpleNamespace(spans=spans, profile={"kernels": kernels})


def test_bytes_over_peak_against_the_kernels_time():
    params = 1_260_360_960  # hubert-xlarge's, bf16 gradients and parameters
    tally = {"launches": 2, "bytes": 30 * params}
    kernels = {"void (anonymous namespace)::optim_norm_kernel(...)": [0.0008, 0.0008],
               "void (anonymous namespace)::optim_adamw_kernel(...)": [0.0110, 0.0112],
               "nvjet_tst_320x128": [0.5]}
    got = READ(_ctx([tally, tally], kernels))
    want = 100.0 * (2 * 30 * params / 3.35e12) / 0.0238
    assert got == pytest.approx(want)
    assert 0 < got < 100


def test_without_the_tally_or_the_kernels_it_reads_none():
    tally = {"launches": 2, "bytes": 30 * 1000}
    kernels = {"void (anonymous namespace)::optim_adamw_kernel(...)": [0.001]}
    assert READ(_ctx([None, None], kernels)) is None  # a program without the tally
    assert READ(_ctx([tally], {"nvjet_tst_320x128": [0.5]})) is None  # the loop ran
    assert READ(_ctx([dict(tally, bytes=0)], kernels)) is None
    assert READ(types.SimpleNamespace(spans=[], profile=None)) is None  # an untraced run
