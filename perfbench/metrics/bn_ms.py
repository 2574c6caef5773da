"""Device ms a training step of the work launched inside the program's
profiler regions ``bn.forward`` and ``bn.backward``: the train-mode
BatchNorms' forwards, and their backwards on autograd's thread
(``perfbench/spans.py``'s rule). None for a program without the regions."""

from perfbench import spans

REGIONS = ("bn.forward", "bn.backward")


def read(ctx):
    if not ctx.calls or not spans.has(ctx.trace, REGIONS):
        return None
    ops = spans.launched(ctx.trace, REGIONS)
    return spans.device_ms(ops) / ctx.calls if ops else None
