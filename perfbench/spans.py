"""The device work launched inside the program's profiler regions, and the
idle time inside and outside them, read from a ``trace.Trace``.

The launched-in rule: a device operation belongs to a region when the
runtime call that launched it (category ``cuda_runtime`` or
``cuda_driver``, joined to the operation by the trace's ``correlation``
id) lies inside one of the region's spans, on the span's own thread or on
an autograd worker thread: one whose host operations include
``autograd::engine::evaluate_function: …``. PyTorch's autograd engine runs
a CUDA backward pass on a thread of its own, so a region around
``autograd.grad`` holds no launch on its own thread; ``trace.launched_in``
counts the region's thread alone. Operations launched inside two of the
regions asked for count once.

The idle time in an interval is its length less the union of the device
operations over it, all streams merged.

The benchmark's own arithmetic: the program's ``device_split`` applies the
same rule to its live profile (timed by the launching operator's start),
and this file repeats it on the exported trace so that the program can
change without moving the benchmark.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

from perfbench import trace

AUTOGRAD_OP = "autograd::engine::evaluate_function"

# the EAST step's passes (R101 forward and the backward) and its per-leaf loops
PASSES = ("east.forward", "optim.backward")
LEAFWISE = ("sam.perturb", "sam.restore", "east.update")


def autograd_threads(tr: trace.Trace) -> set:
    """The threads that ran an autograd engine node."""
    return {op.tid for op in tr.host_ops if op.name.startswith(AUTOGRAD_OP)}


def has(tr: trace.Trace, names: Iterable[str]) -> bool:
    """Whether the trace holds a span of each region in ``names``."""
    return all(tr.region_spans(n) for n in names)


def launched(tr: trace.Trace, names: Sequence[str]) -> List[trace.Span]:
    """The device operations launched inside the spans of ``names``."""
    spans = [s for n in names for s in tr.region_spans(n)]
    workers = autograd_threads(tr)
    out = {}
    for ts, tid, corr in tr.launches:
        if any(s.start <= ts <= s.end and (tid == s.tid or tid in workers) for s in spans):
            for d in tr.device_by_corr.get(corr, ()):
                out[id(d)] = d
    return list(out.values())


def device_ms(ops: Iterable[trace.Span]) -> float:
    return sum(d.end - d.start for d in ops) / 1e3


def intervals(tr: trace.Trace, name: str) -> List[Tuple[float, float]]:
    return [(s.start, s.end) for s in tr.region_spans(name)]


def outside(start: float, end: float, spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The parts of [start, end] that no interval of ``spans`` covers."""
    out, at = [], start
    for a, b in sorted(spans):
        if a > at:
            out.append((at, min(a, end)))
        at = max(at, b)
        if at >= end:
            break
    if at < end:
        out.append((at, end))
    return [(a, b) for a, b in out if b > a]


def idle_ms(tr: trace.Trace, spans: List[Tuple[float, float]]) -> float:
    """ms of the (non-overlapping) intervals in which no device operation ran."""
    return sum((b - a) - trace.busy_us(tr, a, b) for a, b in spans) / 1e3
