"""The per-layer metrics that read the program's regions inside a call or
a step (``perfbench/spans.py``), each on a trace written by hand."""

import pytest

from perfbench import spans, trace
from perfbench.harness import TraceContext, load_module
from perfbench.tests.conftest import REPO
from perfbench.tests.test_perfbench_trace import _x


def _launch(ts, corr, tid=1):
    return _x("cudaLaunchKernel", "cuda_runtime", ts, 1, tid=tid, corr=corr)


def _kernel(name, ts, dur, corr, cat="kernel"):
    return _x(name, cat, ts, dur, tid=7, corr=corr)


# One call (read as two): encode, a decode of two beam steps, the
# confidences, then the caller's copy. The card idles from 110 (inside
# trba.decode) to 146 (after it, inside trba.recognize), and from 150 on
# but for the copy and a kernel another thread launched inside the decode.
RECOGNIZE = {"traceEvents": [
    _x("bench.window", "user_annotation", 0, 200),
    _x("bench.call", "user_annotation", 0, 200),
    _x("trba.recognize", "user_annotation", 10, 140),
    _x("trba.encode", "user_annotation", 12, 48),
    _x("trba.decode", "user_annotation", 62, 78),
    _x("beam.step", "user_annotation", 65, 25),
    _x("beam.step", "user_annotation", 92, 46),
    _launch(20, 1), _kernel("conv", 25, 30, 1),
    _launch(70, 2), _kernel("attention_kernel", 72, 8, 2),
    _launch(75, 3), _kernel("topk", 80, 4, 3),
    _launch(95, 4), _kernel("attention_kernel", 100, 10, 4),
    _launch(100, 7, tid=3), _kernel("other_thread", 186, 4, 7),
    _launch(145, 5), _kernel("confidence", 146, 2, 5),
    _launch(160, 6), _kernel("Memcpy DtoH", 160, 10, 6, cat="gpu_memcpy"),
]}

# One ASAM step: each pass's forward on the calling thread, its backward
# launched by autograd's worker (thread 2), the perturbation, the restore,
# the update; a copy outside the step, and a launch of a third thread
# inside the first backward, which is no region's.
EAST = {"traceEvents": [
    _x("bench.window", "user_annotation", 0, 1000),
    _x("east.step", "user_annotation", 10, 890),
    _x("sam.first_pass", "user_annotation", 20, 380),
    _x("east.forward", "user_annotation", 25, 75),
    _x("optim.backward", "user_annotation", 105, 195),
    _x("sam.perturb", "user_annotation", 305, 85),
    _x("sam.second_pass", "user_annotation", 410, 290),
    _x("east.forward", "user_annotation", 415, 65),
    _x("optim.backward", "user_annotation", 485, 165),
    _x("sam.restore", "user_annotation", 655, 35),
    _x("east.update", "user_annotation", 710, 180),
    _x("autograd::engine::evaluate_function: ConvolutionBackward0", "cpu_op", 110, 180, tid=2),
    _x("autograd::engine::evaluate_function: ConvolutionBackward0", "cpu_op", 490, 150, tid=2),
    _x("aten::add", "cpu_op", 199, 3, tid=3),
    _launch(30, 1), _kernel("conv_fwd", 30, 30, 1),
    _launch(150, 2, tid=2), _kernel("conv_bwd", 150, 50, 2),
    _launch(200, 10, tid=3), _kernel("loader", 205, 5, 10),
    _launch(310, 3), _kernel("abs_mul", 310, 10, 3),
    _launch(420, 4), _kernel("conv_fwd", 420, 20, 4),
    _launch(500, 5, tid=2), _kernel("conv_bwd", 500, 40, 5),
    _launch(660, 6), _kernel("Memcpy DtoD", 660, 5, 6, cat="gpu_memcpy"),
    _launch(720, 7), _kernel("sgd", 720, 10, 7),
    _launch(740, 8), _kernel("add", 740, 5, 8),
    _launch(950, 9), _kernel("Memcpy DtoD", 950, 10, 9, cat="gpu_memcpy"),
]}


def _ctx(doc, calls):
    tr = trace.load(doc)
    start, end = tr.window("bench.window")
    return TraceContext(None, tr, start, end, calls, {})


def _read(name, ctx):
    return load_module(REPO / "perfbench" / "metrics" / f"{name}.py").read(ctx)


@pytest.mark.parametrize("name, want", [
    ("decode_ms", (8 + 4 + 10) / 1e3 / 2),  # the beam steps' three kernels; not the other thread's
    ("decode_idle_ms", (78 - 12 - 10) / 1e3 / 2),  # [62, 140] less [72, 84] and [100, 110]
    ("beam_step_launches", 3 / 2),
    # [0, 10] and [150, 200] less the copy and other_thread's kernel
    ("caller_idle_ms", (10 + 50 - 10 - 4) / 1e3 / 2),
])
def test_a_recognizer_metric_from_a_written_trace(name, want):
    assert _read(name, _ctx(RECOGNIZE, calls=2)) == pytest.approx(want)


@pytest.mark.parametrize("name, want", [
    ("pass_launches_per_step", 4),  # both forwards, both backwards from autograd's thread
    ("pass_ms", (30 + 50 + 20 + 40) / 1e3),
    ("leafwise_launches_per_step", 4),  # the perturbation, the restore and two in the update
    ("leafwise_ms", (10 + 5 + 10 + 5) / 1e3),
])
def test_an_east_metric_from_a_written_trace(name, want):
    assert _read(name, _ctx(EAST, calls=1)) == pytest.approx(want)


def test_the_backward_counts_through_autograds_thread_only():
    tr = trace.load(EAST)
    assert spans.autograd_threads(tr) == {(1, 2)}
    assert tr.launched_in("optim.backward") == []  # the region's own thread launched nothing
    assert sorted(d.name for d in spans.launched(tr, ["optim.backward"])) == ["conv_bwd", "conv_bwd"]
    # nested regions count an operation once: the first pass's three and the second's two
    assert len(spans.launched(tr, ["sam.first_pass", "east.forward", "optim.backward"])) == 5
    assert len(spans.launched(tr, ["east.step"])) == 8


def test_outside_and_idle_of_intervals():
    assert spans.outside(0, 100, [(10, 20), (15, 30), (90, 120)]) == [(0, 10), (30, 90)]
    assert spans.outside(0, 100, []) == [(0, 100)]
    assert spans.outside(0, 100, [(-5, 200)]) == []
    tr = trace.load(RECOGNIZE)
    assert spans.idle_ms(tr, [(0, 10), (100, 120)]) == pytest.approx((10 + 10) / 1e3)


METRICS = ("decode_ms", "decode_idle_ms", "beam_step_launches", "caller_idle_ms", "pass_ms",
           "pass_launches_per_step", "leafwise_launches_per_step", "leafwise_ms")


@pytest.mark.parametrize("name", METRICS)
def test_a_trace_without_the_regions_or_without_the_card_reads_nothing(name):
    """A program without the new regions (the one before them) or a CPU
    trace: no number, and no error."""
    keep = {"bench.window", "bench.call", "trba.encode", "trba.decode", "east.update",
            "sam.first_pass", "sam.second_pass"}
    for doc in (RECOGNIZE, EAST):
        old = {"traceEvents": [e for e in doc["traceEvents"]
                               if e["cat"] != "user_annotation" or e["name"] in keep]}
        cpu = {"traceEvents": [e for e in doc["traceEvents"]
                               if e["cat"] not in ("kernel", "gpu_memcpy", "cuda_runtime")]}
        assert _read(name, _ctx(cpu, calls=1)) is None
        value = _read(name, _ctx(old, calls=1))
        assert value is None or name in ("decode_ms", "decode_idle_ms")  # trba.decode is older
