"""Device operations a training step launched inside the program's
profiler region ``trba.optimizer``: the TRBA trainer's clip, Adam and
apply, leaf by leaf."""

from perfbench import spans


def read(ctx):
    if not ctx.calls or not spans.has(ctx.trace, ["trba.optimizer"]):
        return None
    ops = spans.launched(ctx.trace, ["trba.optimizer"])
    return len(ops) / ctx.calls if ops else None
