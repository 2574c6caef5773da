"""Device operations a training step launched inside the program's profiler
regions ``bn.forward`` and ``bn.backward`` (the backward's on autograd's
thread, ``perfbench/spans.py``): the train-mode BatchNorms' launches. None
for a program without the regions."""

from perfbench import spans

REGIONS = ("bn.forward", "bn.backward")


def read(ctx):
    if not ctx.calls or not spans.has(ctx.trace, REGIONS):
        return None
    ops = spans.launched(ctx.trace, REGIONS)
    return len(ops) / ctx.calls if ops else None
