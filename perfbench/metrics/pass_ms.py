"""Device ms a training step of the work launched inside the program's
profiler regions ``east.forward`` and ``optim.backward``: the model's
forward passes and the backward passes on autograd's thread
(``perfbench/spans.py``'s rule)."""

from perfbench import spans


def read(ctx):
    if not ctx.calls or not spans.has(ctx.trace, spans.PASSES):
        return None
    ops = spans.launched(ctx.trace, spans.PASSES)
    return spans.device_ms(ops) / ctx.calls if ops else None
