"""The share of the window in which no operation ran on the device, in %:
one minus the union of the trace's device intervals over the window."""


def read(ctx):
    if not ctx.profile or not ctx.profile["busy_s"]:
        return None
    return 100.0 * (1.0 - ctx.profile["busy_s"] / ctx.window_s)
