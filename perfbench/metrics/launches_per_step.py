"""Device operations (kernels, copies, memsets) a training step, counted in
the trace over the traced steps."""


def read(ctx):
    ops = ctx.trace.device_in(ctx.start, ctx.end)
    if not ops or not ctx.calls:
        return None
    return len(ops) / ctx.calls
