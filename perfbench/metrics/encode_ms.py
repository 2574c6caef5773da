"""Device ms a call of the work launched inside the program's profiler
region ``trba.encode``."""


def read(ctx):
    ops = ctx.trace.launched_in("trba.encode")
    if not ops or not ctx.calls:
        return None
    return sum(d.end - d.start for d in ops) / 1e3 / ctx.calls
