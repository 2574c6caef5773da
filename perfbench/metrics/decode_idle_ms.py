"""Idle ms a call inside the spans of the program's profiler region
``trba.decode``: their time in which no kernel, copy or memset ran on any
stream of the card."""

from perfbench import spans


def read(ctx):
    tr = ctx.trace
    if not tr.device or not ctx.calls or not spans.has(tr, ["trba.decode"]):
        return None
    return spans.idle_ms(tr, spans.intervals(tr, "trba.decode")) / ctx.calls
