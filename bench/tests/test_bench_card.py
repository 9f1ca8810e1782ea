"""On the card: a tiny cell through the whole harness, the CUDA gather and
the graphed step included (skips without a card)."""

import pytest

from conftest import tiny_cell


@pytest.mark.card
@pytest.mark.parametrize("workload", ["hubert-xlarge.frames2k", "zamba2-1.2b.tokens2k"])
def test_tiny_cell_on_the_card(workload, cuda_device):
    from bench import harness

    res = harness.run_cell(tiny_cell(workload, "float32"), 2**31 + 3, 0.5, True,
                           device=cuda_device, log=lambda *a: None)
    assert res["correct"], res["checks"]
    checks = res["checks"]
    for name in ("gather_launches_off", "gather_launches_in_graph", "steps_not_graphed"):
        assert checks[name]["value"] == 0
    assert res["profile"]["busy_s"] > 0
    assert 0 < res["per_layer"]["step_mfu"][0] < 100
