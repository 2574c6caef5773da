"""``bn_ms`` and ``bn_launches_per_step``: the train-mode BatchNorms'
launches inside ``bn.forward`` and ``bn.backward``, each on a trace written
by hand, and nothing from a program without the regions."""

import pytest

from perfbench.harness import TraceContext, load_module
from perfbench.tests.conftest import REPO
from perfbench import trace
from perfbench.tests.test_perfbench_trace import _x


def _launch(ts, corr, tid=1):
    return _x("cudaLaunchKernel", "cuda_runtime", ts, 1, tid=tid, corr=corr)


def _kernel(name, ts, dur, corr):
    return _x(name, "kernel", ts, dur, tid=7, corr=corr)


# Two steps of one pass: a convolution, a BatchNorm's two kernels in
# ``bn.forward``; the backward on autograd's thread 2, a BatchNorm's two
# kernels in ``bn.backward``, a layout copy in it, then the convolution's.
STEPS = {"traceEvents": [_x("bench.window", "user_annotation", 0, 400)]}
for step, t in enumerate((0, 200)):
    c = 10 * step
    STEPS["traceEvents"] += [
        _x("east.forward", "user_annotation", t + 5, 60),
        _launch(t + 10, c + 1), _kernel("conv", t + 10, 10, c + 1),
        _x("bn.forward", "user_annotation", t + 30, 20),
        _launch(t + 32, c + 2), _kernel("stats_rows", t + 32, 4, c + 2),
        _launch(t + 40, c + 3), _kernel("apply_rows", t + 40, 3, c + 3),
        _x("optim.backward", "user_annotation", t + 70, 120),
        _x("autograd::engine::evaluate_function: _BatchNormBackward", "cpu_op", t + 80, 60, tid=2),
        _x("bn.backward", "user_annotation", t + 85, 40, tid=2),
        _launch(t + 86, c + 4, tid=2), _kernel("copy", t + 86, 2, c + 4),
        _launch(t + 90, c + 5, tid=2), _kernel("sums_rows", t + 90, 6, c + 5),
        _launch(t + 100, c + 6, tid=2), _kernel("grad_rows", t + 100, 5, c + 6),
        _launch(t + 150, c + 7, tid=2), _kernel("conv_bwd", t + 150, 20, c + 7),
    ]


def _read(name, doc, calls):
    tr = trace.load(doc)
    start, end = tr.window("bench.window")
    return load_module(REPO / "perfbench" / "metrics" / f"{name}.py").read(
        TraceContext(None, tr, start, end, calls, {}))


@pytest.mark.parametrize("name, want", [
    ("bn_launches_per_step", 5),  # two forward, the copy and two backward kernels
    ("bn_ms", (4 + 3 + 2 + 6 + 5) / 1e3),
])
def test_the_batch_norms_kernels_a_step(name, want):
    assert _read(name, STEPS, calls=2) == pytest.approx(want)


@pytest.mark.parametrize("name", ["bn_ms", "bn_launches_per_step"])
def test_a_program_without_the_regions_or_a_cpu_trace_reads_nothing(name):
    events = STEPS["traceEvents"]
    old = {"traceEvents": [e for e in events if not e["name"].startswith("bn.")]}
    cpu = {"traceEvents": [e for e in events if e["cat"] not in ("kernel", "cuda_runtime")]}
    assert _read(name, old, calls=2) is None
    assert _read(name, cpu, calls=2) is None
