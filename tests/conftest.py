"""Give each pytest-xdist worker one share of the CPUs for torch's threads.

Left alone, torch starts one OpenMP thread per CPU in every worker: under
``-n 6`` on eight CPUs that is 48 spinning threads, and a case that takes
5 s in one process took over 600 s in the whole run. So a worker of an
xdist run with more than one worker gets ``CPUs // workers`` threads (at
least one) through ``OMP_NUM_THREADS`` and ``MKL_NUM_THREADS``, which the
subprocesses its tests start inherit too. Where the caller set either
variable, torch already follows it and nothing is changed. A run in one
process is left as it is. XLA's thread pools are not capped.
"""
import os
import sys

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1 and not {"OMP_NUM_THREADS", "MKL_NUM_THREADS"} & os.environ.keys():
    _share = max(1, len(os.sched_getaffinity(0)) // _WORKERS)
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = str(_share)
    if "torch" in sys.modules:
        sys.modules["torch"].set_num_threads(_share)
