"""Device operations a training step launched inside the program's
profiler regions ``east.forward`` and ``optim.backward`` (the backward's
on autograd's thread included, ``perfbench/spans.py``)."""

from perfbench import spans


def read(ctx):
    if not ctx.calls or not spans.has(ctx.trace, spans.PASSES):
        return None
    ops = spans.launched(ctx.trace, spans.PASSES)
    return len(ops) / ctx.calls if ops else None
