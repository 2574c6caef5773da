"""Device operations launched inside the program's profiler region
``beam.step``, one step of the beam loop, over the count of its spans."""

from perfbench import spans


def read(ctx):
    steps = len(ctx.trace.region_spans("beam.step"))
    ops = spans.launched(ctx.trace, ["beam.step"])
    if not steps or not ops:
        return None
    return len(ops) / steps
