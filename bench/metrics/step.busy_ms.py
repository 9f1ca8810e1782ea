"""Device-busy milliseconds a step: the union of the device's kernel, copy
and set intervals in the window's trace, over the window's steps."""


def read(ctx):
    if not ctx.profile or not ctx.profile["busy_s"] or not ctx.steps:
        return None
    return 1e3 * ctx.profile["busy_s"] / ctx.steps
