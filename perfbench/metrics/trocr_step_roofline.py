"""TrOCR's decode steps' share of their roofline, in %: the least time of
the traced calls' steps (each step's larger of its FLOPs over the float32
peak and its least bytes over the memory rate, ``perfbench/counts_trocr.py``)
over the device time of the work launched inside the spans of the
program's profiler region ``trocr.step``."""

from perfbench import counts, counts_trocr, spans


def read(ctx):
    steps = len(ctx.trace.region_spans("trocr.step"))
    ops = spans.launched(ctx.trace, ["trocr.step"])
    if not steps or not ops or "lines" not in ctx.counts:
        return None
    least_ms, per_call = counts_trocr.steps_least_ms(ctx.cell.config, ctx.counts["lines"])
    return counts.percent(least_ms * steps / per_call, spans.device_ms(ops))
