"""The whole train step's share of the H100's dense bf16 peak (989 TFLOP/s,
NVIDIA's H100 SXM data sheet), in %: the model FLOPs of the window's steps
(``bench/flops.py``, no recomputation counted) over the peak times the
window's seconds."""

BF16_FLOP_PER_S = 989e12


def read(ctx):
    if not ctx.steps:
        return None
    return 100.0 * ctx.step_flops() * ctx.steps / (BF16_FLOP_PER_S * ctx.window_s)
