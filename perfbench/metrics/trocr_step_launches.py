"""Device operations launched inside the program's profiler region
``trocr.step``, one step of TrOCR's beam loop, over the count of its spans."""

from perfbench import spans


def read(ctx):
    steps = len(ctx.trace.region_spans("trocr.step"))
    ops = spans.launched(ctx.trace, ["trocr.step"])
    if not steps or not ops:
        return None
    return len(ops) / steps
