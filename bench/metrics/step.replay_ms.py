"""Device milliseconds a step, measured where the step runs: the mean
device interval of the window's ``train.step`` spans (``GraphTrain``'s
static-input copies and graph replay, ``train/train_step.py``), from the
timing events the program records on its stream. ``step.busy_ms`` times
the same layer from outside, through the profiler."""


def read(ctx):
    durs = [ev[5]["dev_dur"] for ev in ctx.spans
            if ev[0] == "train.step" and ev[5] and "dev_dur" in ev[5]]
    return 1e3 * sum(durs) / len(durs) if durs else None
