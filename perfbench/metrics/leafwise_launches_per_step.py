"""Device operations a training step launched inside the program's
profiler regions ``sam.perturb``, ``sam.restore`` and ``east.update``: the
loops over the parameter tensors (ASAM's perturbation and restore, the
guard, clip, SGD, apply and EMA)."""

from perfbench import spans


def read(ctx):
    if not ctx.calls or not spans.has(ctx.trace, spans.LEAFWISE):
        return None
    ops = spans.launched(ctx.trace, spans.LEAFWISE)
    return len(ops) / ctx.calls if ops else None
