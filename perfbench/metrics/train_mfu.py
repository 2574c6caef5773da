"""The training steps' share of the card's dense TF32 peak, in %: the
benchmark's FLOP count of the traced steps, at the sides they drew, over
the traced window's seconds."""

from perfbench import counts


def read(ctx):
    if not ctx.trace.device or ctx.seconds <= 0 or "traced_flops" not in ctx.counts:
        return None
    return counts.percent(ctx.counts["traced_flops"] / ctx.seconds, counts.TF32_FLOPS)
