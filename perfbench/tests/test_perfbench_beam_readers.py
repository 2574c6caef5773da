"""``beam_advance_ms``: the launches inside ``beam.advance``, on a trace
written by hand, and nothing from a program without the region."""

import pytest

from perfbench import trace
from perfbench.harness import TraceContext, load_module
from perfbench.tests.conftest import REPO
from perfbench.tests.test_perfbench_trace import _x


def _launch(ts, corr):
    return _x("cudaLaunchKernel", "cuda_runtime", ts, 1, tid=1, corr=corr)


def _kernel(name, ts, dur, corr):
    return _x(name, "kernel", ts, dur, tid=7, corr=corr)


# Two calls of two beam steps each: the decoder's GEMM, then the advance's
# two kernels inside ``beam.advance``, then a reorder gather after it.
CALLS = {"traceEvents": [_x("bench.window", "user_annotation", 0, 800)]}
for n, t in enumerate(range(0, 800, 200)):
    c = 10 * n
    CALLS["traceEvents"] += [
        _x("beam.step", "user_annotation", t + 5, 150),
        _launch(t + 10, c + 1), _kernel("gemm", t + 10, 30, c + 1),
        _x("beam.advance", "user_annotation", t + 50, 40),
        _launch(t + 52, c + 2), _kernel("beam_lse", t + 60, 6, c + 2),
        _launch(t + 60, c + 3), _kernel("beam_top<4>", t + 70, 5, c + 3),
        _launch(t + 100, c + 4), _kernel("index", t + 100, 2, c + 4),
    ]


def _read(doc, calls):
    tr = trace.load(doc)
    start, end = tr.window("bench.window")
    return load_module(REPO / "perfbench" / "metrics" / "beam_advance_ms.py").read(
        TraceContext(None, tr, start, end, calls, {}))


def test_the_advances_kernels_a_call():
    assert _read(CALLS, calls=2) == pytest.approx(4 * (6 + 5) / 1e3 / 2)


@pytest.mark.parametrize("drop", ["region", "device"])
def test_a_program_without_the_region_or_a_cpu_trace_reads_nothing(drop):
    events = CALLS["traceEvents"]
    if drop == "region":
        doc = {"traceEvents": [e for e in events if e["name"] != "beam.advance"]}
    else:
        doc = {"traceEvents": [e for e in events if e["cat"] not in ("kernel", "cuda_runtime")]}
    assert _read(doc, calls=2) is None
    assert _read(CALLS, calls=0) is None
