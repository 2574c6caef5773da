"""Device ms a call of the work launched inside the program's profiler
region ``trocr.decode``, TrOCR's cross keys and values and its beam steps
(``perfbench/spans.py``'s rule)."""

from perfbench import spans


def read(ctx):
    ops = spans.launched(ctx.trace, ["trocr.decode"])
    if not ops or not ctx.calls:
        return None
    return spans.device_ms(ops) / ctx.calls
