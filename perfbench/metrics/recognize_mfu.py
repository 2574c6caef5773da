"""The recognition calls' share of the card's dense TF32 peak, in %: the
benchmark's FLOP count of a call times the traced calls, over the traced
window's seconds."""

from perfbench import counts


def read(ctx):
    if not ctx.trace.device or ctx.seconds <= 0 or "call_flops" not in ctx.counts:
        return None
    return counts.percent(ctx.counts["call_flops"] * ctx.calls / ctx.seconds, counts.TF32_FLOPS)
