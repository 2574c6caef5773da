"""Device ms a call of the work launched inside the program's profiler
region ``beam.advance``: the beam's selection of the kept beams, each step
of TRBA's and TrOCR's beams (``perfbench/spans.py``'s rule). None for a
program without the region."""

from perfbench import spans

REGIONS = ("beam.advance",)


def read(ctx):
    if not ctx.calls or not spans.has(ctx.trace, REGIONS):
        return None
    ops = spans.launched(ctx.trace, REGIONS)
    return spans.device_ms(ops) / ctx.calls if ops else None
