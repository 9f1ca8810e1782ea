"""``bench/metrics/attn.flash_roofline.py`` on hand-made contexts: the
FLOPs that the ``train.step`` spans' ``attn.flash_calls`` carry over the
peak, against the traced time of the ``flash_attention`` kernels, and
nothing where the counter or the kernels are missing."""

import types

import pytest

from bench import harness
from repro_torch.kernels.flash_attention.ops import attention_flops

READ = harness._metric_reader("attn.flash_roofline")


def _ctx(calls, kernels):
    spans = [("train.step", "compute", 0.0, 1.0, 0, None if c is None else {"attn.flash_calls": c})
             for c in calls]
    spans.append(("train.feed", "data", 0.0, 0.1, 0, {}))
    return types.SimpleNamespace(spans=spans, profile={"kernels": kernels})


def _calls(shape, causal, window=0, checkpointed=True):
    fwd = attention_flops(shape, causal, window)
    bwd = attention_flops(shape, causal, window, backward=True)
    n = 2 if checkpointed else 1
    return {"forward": n, "backward": 1, "forward_flops": n * fwd, "backward_flops": bwd,
            "flops": n * fwd + bwd}


@pytest.mark.parametrize("causal", [False, True])
def test_flops_over_peak_against_the_kernels_time(causal):
    shape = (8, 2048, 16, 80)
    call = _calls(shape, causal)
    # 4 B H D P forward twice and 10 B H D P backward, P = S^2 or S(S+1)/2
    pairs = 2048 * 2049 // 2 if causal else 2048 ** 2
    assert call["flops"] == (2 * 4 + 10) * 8 * 16 * 80 * pairs
    kernels = {"void flash_attention_wgmma_kernel<80, false, true>(...)": [0.002, 0.002],
               "void flash_attention_bwd_kernel<80, false>(...)": [0.004],
               "void flash_attention_bwd_prep_kernel<80>(...)": [0.0005],
               "void flash_attention_bwd_dq_kernel<80>(...)": [0.0005],
               "nvjet_tst_320x128": [0.5]}
    got = READ(_ctx([call, call], kernels))
    want = 100.0 * (2 * call["flops"] / 989e12) / 0.009
    assert got == pytest.approx(want)
    assert 0 < got < 100


def test_without_the_counter_or_the_kernels_it_reads_none():
    call = _calls((2, 512, 4, 64), True)
    kernels = {"void flash_attention_bwd_kernel<64, false>(...)": [0.001]}
    assert READ(_ctx([None, None], kernels)) is None  # a program without the counter
    assert READ(_ctx([call], {"nvjet_tst_320x128": [0.5]})) is None  # no kernel traced
    zero = dict(call, flops=0)
    assert READ(_ctx([zero], kernels)) is None  # the route never ran
    assert READ(types.SimpleNamespace(spans=[], profile=None)) is None  # an untraced run
