"""The share of the window in which the card waited for Redox, in %: the
trainer's thread was inside the stager's wait (the program's
``stager.wait`` span, ``core/device.py``) while no device interval of the
program's ``train.feed`` or ``train.step`` spans was running. A wait that
a step still queued on the card covers is no stall. Read from the
program's spans alone; a program without device-timed ``train.step``
spans reads nothing."""

TRAINER_WORK = ("train.feed", "train.step")


def _union(intervals) -> list:
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def _device_interval(ev):
    args = ev[5]
    if not args or "dev_dur" not in args:
        return None
    return args["dev_ts"], args["dev_ts"] + args["dev_dur"]


def read(ctx):
    steps = [ev for ev in ctx.spans if ev[0] == "train.step" and _device_interval(ev)]
    if not steps:
        return None
    trainer = {ev[4] for ev in steps}
    busy = _union(_device_interval(ev) for ev in ctx.spans
                  if ev[0] in TRAINER_WORK and _device_interval(ev))
    waits = _union((ev[2], ev[2] + ev[3]) for ev in ctx.spans
                   if ev[0] == "stager.wait" and ev[4] in trainer and ev[3] >= 0)
    stall = 0.0
    for lo, hi in waits:
        stall += hi - lo - sum(max(0.0, min(hi, b1) - max(lo, b0)) for b0, b1 in busy)
    return 100.0 * stall / ctx.window_s
