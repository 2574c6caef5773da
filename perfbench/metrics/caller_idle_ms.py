"""Idle ms a call inside the traced window and outside every span of the
program's profiler region ``trba.recognize``: the card's wait on the
caller (the copy of the answers to the host, the texts' decoding, the next
call's first launch)."""

from perfbench import spans


def read(ctx):
    tr = ctx.trace
    if not tr.device or not ctx.calls or not spans.has(tr, ["trba.recognize"]):
        return None
    gaps = spans.outside(ctx.start, ctx.end, spans.intervals(tr, "trba.recognize"))
    return spans.idle_ms(tr, gaps) / ctx.calls
