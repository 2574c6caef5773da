"""The trace reader: a recorded CPU trace, and the device arithmetic on a
trace written by hand."""

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import trace


def test_a_recorded_cpu_trace_has_its_regions_and_no_device_time(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            for _ in range(3):
                with record_function("bench.call"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    tr = trace.load(path)
    assert len(tr.region_spans("bench.call")) == 3
    start, end = tr.window("bench.window")
    assert end > start
    assert all(start <= s.start and s.end <= end for s in tr.region_spans("bench.call"))
    assert any(op.name == "aten::mm" for op in tr.host_ops)
    assert tr.device == [] and tr.launched_in("bench.call") == []
    assert trace.idle_percent(tr, start, end) is None
    assert trace.device_ops(tr, start, end) == []


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


DOC = {"traceEvents": [
    _x("bench.window", "user_annotation", 0, 100),
    _x("trba.encode", "user_annotation", 0, 30),
    _x("aten::conv2d", "cpu_op", 1, 20),
    _x("cudaLaunchKernel", "cuda_runtime", 2, 1, corr=7),
    _x("cudaLaunchKernel", "cuda_runtime", 40, 1, corr=8),
    _x("aten::item", "cpu_op", 38, 52),
    _x("conv_kernel", "kernel", 10, 20, tid=7, corr=7),
    _x("attention_kernel(float const*)", "kernel", 25, 15, tid=8, corr=8),
    _x("Memcpy DtoH", "gpu_memcpy", 80, 10, tid=7),
    {"ph": "i", "name": "marker", "ts": 5},
]}


def test_busy_idle_gaps_and_regions_from_a_written_trace():
    tr = trace.load(DOC)
    assert trace.busy_us(tr, 0, 100) == 40.0  # [10, 40] and [80, 90], streams merged
    assert trace.idle_percent(tr, 0, 100) == 60.0
    assert [d.name for d in tr.launched_in("trba.encode")] == ["conv_kernel"]
    ops = trace.device_ops(tr, 0, 100)
    assert ops[0] == ["conv_kernel", 20 / 1e6] and len(ops) == 3
    gaps = trace.idle_gaps(tr, 0, 100)
    # 40 → 80, the host in aten::item; 0 → 10 inside trba.encode; 90 → 100
    assert gaps == [["bench.window/aten::item", 40 / 1e6], ["trba.encode", 10 / 1e6],
                    ["bench.window", 10 / 1e6]]
