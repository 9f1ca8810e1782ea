"""The fused clip and AdamW update's share of its roofline, in %: the bytes
the optimizer's kernels must move in the window over the H100's 3.35 TB/s,
against the traced device time of those kernels (``optim_norm_kernel``,
the global norm's sum of squares, and ``optim_adamw_kernel``, the update:
both named ``optim_...``).

The bytes come from the program's ``optim.update_bytes`` tally, which each
``train.step`` span carries (``train/train_step.py``): the norm reads each
gradient once, the update reads g, m, v and the f32 master and writes m,
v, the master and the parameter, 30 bytes a parameter for bf16 gradients
and parameters. About 20 operations an element lie far below the card's
rate, so bytes bound the kernels, and a count of what the update must move
cannot read above 100%. A program without the tally or the kernels (the
optimizer run op by op) gives nothing."""

PEAK_BYTES_PER_S = 3.35e12
KERNEL = "optim_"
COUNTER = "optim.update_bytes"


def read(ctx):
    if not ctx.profile:
        return None
    moved = sum(ev[5][COUNTER]["bytes"] for ev in ctx.spans
                if ev[0] == "train.step" and ev[5] and COUNTER in ev[5])
    times = [t for name, ts in ctx.profile["kernels"].items() if KERNEL in name for t in ts]
    if not moved or not times:
        return None
    return 100.0 * (moved / PEAK_BYTES_PER_S) / sum(times)
