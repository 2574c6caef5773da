"""K1's share of its roofline, in %: the least time of one decode step at
the cell's beam rows (the larger of its operations over the float32 peak
and its bytes over the memory rate, by the benchmark's own count) over K1's
measured device time a step (its three grids, found by kernel name, over
the count of its attention grids)."""

import re

from perfbench import counts

ATTENTION = re.compile(r"\battention_kernel\b")
TILES = re.compile(r"\btile_kernel<")


def read(ctx):
    ops = ctx.trace.device_in(ctx.start, ctx.end)
    steps = sum(1 for d in ops if ATTENTION.search(d.name))
    us = sum(d.end - d.start for d in ops if ATTENTION.search(d.name) or TILES.search(d.name))
    if not steps or us <= 0:
        return None
    c, cfg = ctx.counts, ctx.cell.config
    flops, nbytes = counts.k1_step_cost(c["words"], c["rows"], c["t"], cfg["hidden_size"],
                                        cfg["hidden_size"], min(c["rows"], cfg["num_classes"]))
    least_ms, _ = counts.bound_ms(nbytes, flops)
    return counts.percent(least_ms, us / 1e3 / steps)
