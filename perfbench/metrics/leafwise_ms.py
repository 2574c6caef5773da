"""Device ms a training step of the work launched inside the program's
profiler regions ``sam.perturb``, ``sam.restore`` and ``east.update``, the
loops over the parameter tensors."""

from perfbench import spans


def read(ctx):
    if not ctx.calls or not spans.has(ctx.trace, spans.LEAFWISE):
        return None
    ops = spans.launched(ctx.trace, spans.LEAFWISE)
    return spans.device_ms(ops) / ctx.calls if ops else None
