"""Idle ms a training step inside the spans of the program's profiler
region ``trba.optimizer``: their time in which no kernel, copy or memset
ran on any stream of the card, which is where the host's launches of
Adam leaf by leaf hold the card back."""

from perfbench import spans


def read(ctx):
    tr = ctx.trace
    if not tr.device or not ctx.calls or not spans.has(tr, ["trba.optimizer"]):
        return None
    return spans.idle_ms(tr, spans.intervals(tr, "trba.optimizer")) / ctx.calls
