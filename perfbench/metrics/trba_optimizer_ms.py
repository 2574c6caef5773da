"""Device ms a training step of the work launched inside the program's
profiler region ``trba.optimizer``: the TRBA trainer's clip, Adam and
apply over the parameter tensors."""

from perfbench import spans


def read(ctx):
    if not ctx.calls or not spans.has(ctx.trace, ["trba.optimizer"]):
        return None
    ops = spans.launched(ctx.trace, ["trba.optimizer"])
    return spans.device_ms(ops) / ctx.calls if ops else None
