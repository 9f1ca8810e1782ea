"""The training gather's share of its roofline, in %: the bytes a call must
move (``bench/bytes.py``, the mean over the window's batches) over the
H100's 3.35 TB/s, against the mean device time of a
``chunk_gather_train_kernel`` call in the trace. The call moves a few
hundred KB and does no arithmetic worth counting, so its bound is the
bytes."""

HBM_BYTES_PER_S = 3.35e12
KERNEL = "chunk_gather_train_kernel"


def read(ctx):
    if not ctx.profile:
        return None
    times = [t for name, ts in ctx.profile["kernels"].items() if KERNEL in name for t in ts]
    moved = ctx.gather_bytes()
    if not times or not moved:
        return None
    least = (sum(moved) / len(moved)) / HBM_BYTES_PER_S
    return 100.0 * least / (sum(times) / len(times))
