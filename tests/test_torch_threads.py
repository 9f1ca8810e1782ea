"""``tests/conftest.py`` gives each xdist worker one share of the CPUs for
torch's threads, and its subprocesses inherit it; a run in one process keeps
torch's default. Without the share the workers' threads oversubscribe the
CPUs and the suite takes several times as long."""

import os
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.torch_port

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))


def _share() -> int:
    """The conftest's share: the CPUs this process may run on over the
    workers, at least 1; or, where the caller set a thread count, that count
    as torch reads it (``MKL_NUM_THREADS`` before ``OMP_NUM_THREADS``)."""
    return int(os.environ.get("MKL_NUM_THREADS") or os.environ.get("OMP_NUM_THREADS")
               or max(1, len(os.sched_getaffinity(0)) // WORKERS))


def _fresh_count() -> int:
    """torch's thread count in a new interpreter started with this
    process's environment."""
    out = subprocess.run([sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return int(out.stdout.strip())


def test_this_process_runs_torch_on_its_share_of_the_cpus():
    want = _share() if WORKERS > 1 else _fresh_count()
    assert torch.get_num_threads() == want


def test_a_subprocess_inherits_the_share():
    want = _share() if WORKERS > 1 else torch.get_num_threads()
    assert _fresh_count() == want
