"""The held experts' grouped products' share of their roofline, in %: their
FLOPs in the window over the H100's 989 TFLOP/s (bf16, dense), against the
traced device time of the kernels that run them.

The FLOPs come from the program's ``moe.expert_rows`` counter (the rows
each step routed to each held expert, ``bench/metrics/moe.imbalance.py``
reads them): a row costs ``2 * d_model * d_ff`` in each of the
relu² expert's two products (up and down) in each pass that runs the products:
the forward, the checkpoint's recompute (``remat`` other than "none"),
and the input and weight gradients. The products' FLOPs lie far above
their bytes over 3.35 TB/s, so the FLOPs bound them. The kernels are
``torch._grouped_mm``'s on the card: CUTLASS's grouped GEMM
(``GroupProblemShape`` in its name) and the launch that prepares its
problem sizes (``prepare_grouped_gemm_data``)."""

import importlib.util
from pathlib import Path

PEAK_FLOPS = 989e12
KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def _step_rows():
    path = Path(__file__).with_name("moe.imbalance.py")
    spec = importlib.util.spec_from_file_location("bench_metric_moe_imbalance_rows", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.step_rows


def read(ctx):
    if not ctx.profile:
        return None
    rows = sum(sum(map(sum, step)) for step in _step_rows()(ctx))
    times = [t for name, ts in ctx.profile["kernels"].items()
             if any(k in name for k in KERNELS) for t in ts]
    if not rows or not times:
        return None
    m = ctx.cell.model
    passes = 3 + (ctx.cell.train["remat"] != "none")
    flops = rows * 2 * 2 * m["d_model"] * m["d_ff"] * passes
    return 100.0 * (flops / PEAK_FLOPS) / sum(times)
