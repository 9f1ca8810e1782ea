"""Multi-head latent attention's training kernels' share of their roofline,
in %: the FLOPs of the window's (192, 128) MLA launches over the H100's
989 TFLOP/s (bf16, dense), against the traced device time of every kernel
those launches run (the forward with its log-sum-exp, the backward's
pre-pass, main kernel and dQ conversion: all named ``flash_mla...``).

The FLOPs come from the program's ``attn.mla_calls``, which each
``train.step`` span carries (``train/train_step.py``): a forward launch
counts ``2 B H P (Dqk + Dv)`` and a backward ``2 B H P (3 Dqk + 2 Dv)``
(S, dK and dQ at the query / key width, dP and dV at the value width), P
the (query, key) pairs the mask keeps. So it reads a lower bound on the
work done and cannot pass 100%. A program without the counter or without
the kernels gives nothing."""

PEAK_FLOPS = 989e12
KERNEL = "flash_mla"
COUNTER = "attn.mla_calls"


def read(ctx):
    if not ctx.profile:
        return None
    flops = sum(ev[5][COUNTER]["flops"] for ev in ctx.spans
                if ev[0] == "train.step" and ev[5] and COUNTER in ev[5])
    times = [t for name, ts in ctx.profile["kernels"].items() if KERNEL in name for t in ts]
    if not flops or not times:
        return None
    return 100.0 * (flops / PEAK_FLOPS) / sum(times)
