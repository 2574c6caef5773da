"""Device ms a call of the work launched inside the program's profiler
region ``trocr.encode``, TrOCR's ViT encoder (``perfbench/spans.py``'s rule)."""

from perfbench import spans


def read(ctx):
    ops = spans.launched(ctx.trace, ["trocr.encode"])
    if not ops or not ctx.calls:
        return None
    return spans.device_ms(ops) / ctx.calls
