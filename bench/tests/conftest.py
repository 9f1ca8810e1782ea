"""Shared helpers of the benchmark's own tests (run with
``python -m pytest bench/tests``; the repository's suite does not collect
them). Tests marked ``card`` need a CUDA card and skip without one; the
look for a card is made inside a fixture, never at import."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: Sizes at which a cell runs on the CPU in seconds: every width cut, the
#: structure (layer kinds, frame stub, shared block, chunked scan) kept.
TINY_MODELS = {
    "encoder": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                    d_ff=128, frontend_dim=32),
    "hybrid": dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                   d_ff=128, vocab_size=96, ssm_state=16, ssm_head_dim=16, attn_every=2,
                   ssm_chunk=16),
}
TINY_MIX = dict(seq_len=64, mean_len=32, min_len=4, max_len=128)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def tiny_cell(workload: str, dtype: str = "float32"):
    """``workload`` of BENCHMARK.json at the tiny sizes above, in ``dtype``,
    with the cell's own limits."""
    from bench import harness

    cell = copy.deepcopy(harness.load_cell(workload))
    cell.model.update(TINY_MODELS[cell.model["family"]], param_dtype=dtype, compute_dtype=dtype)
    cell.mix.update(TINY_MIX)
    return cell


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
