"""The training attention kernels' share of their roofline, in %: the FLOPs
of the flash-attention training launches in the window over the H100's
989 TFLOP/s (bf16, dense), against the traced device time of every kernel
those launches run (the forward with its log-sum-exp, the backward's
pre-pass, main kernel, dQ conversion and GQA reduction: all named
``flash_attention...``).

The FLOPs come from the program's ``attn.flash_calls``, which each
``train.step`` span carries (``train/train_step.py``): a forward launch
counts ``4 B H D P`` and a backward ``10 B H D P`` (the S, dP, dV, dK and
dQ products), P the (query, key) pairs the mask keeps and D the model's
head dim, not a padded tile width. So it reads a lower bound on the work
done and cannot pass 100%. The products' FLOPs lie far above their bytes
over 3.35 TB/s at these lengths, so the FLOPs bound them. A program
without the counter or without the kernels gives nothing."""

PEAK_FLOPS = 989e12
KERNEL = "flash_attention"
COUNTER = "attn.flash_calls"


def read(ctx):
    if not ctx.profile:
        return None
    flops = sum(ev[5][COUNTER]["flops"] for ev in ctx.spans
                if ev[0] == "train.step" and ev[5] and COUNTER in ev[5])
    times = [t for name, ts in ctx.profile["kernels"].items() if KERNEL in name for t in ts]
    if not flops or not times:
        return None
    return 100.0 * (flops / PEAK_FLOPS) / sum(times)
