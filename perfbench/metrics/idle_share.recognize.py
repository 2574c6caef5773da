"""The share of the traced window, in %, in which no kernel, copy or memset
ran on any stream of the card."""

from perfbench import trace


def read(ctx):
    return trace.idle_percent(ctx.trace, ctx.start, ctx.end)
