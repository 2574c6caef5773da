"""Device ms a training step of the work launched inside the program's
profiler regions ``trba.forward`` and ``trba.backward``: TRBA's
teacher-forced forward with its loss, and the backward on autograd's
thread (``perfbench/spans.py``'s rule)."""

from perfbench import spans

PASSES = ("trba.forward", "trba.backward")


def read(ctx):
    if not ctx.calls or not spans.has(ctx.trace, PASSES):
        return None
    ops = spans.launched(ctx.trace, PASSES)
    return spans.device_ms(ops) / ctx.calls if ops else None
