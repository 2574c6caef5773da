"""The port's profiling helpers (``manuscript_tpu_torch/utils/profiling.py``)
against the JAX package's ``utils/profiling.py``, on the CPU: the stage
timer's format, the trace, the device split's refusal of a trace without
device events, and the FLOP count."""

import json

import numpy as np
import pytest
import torch

from manuscript_tpu.utils import profiling as jprof
from manuscript_tpu_torch.ops import attention_step as k1
from manuscript_tpu_torch.utils import profiling


def test_stage_timer_report_and_dict_match_the_jax_format():
    stages = [("detect", 0.12345), ("recognize", 1.5), ("finish", 0.0004)]
    timers = [jprof.StageTimer(), profiling.StageTimer()]
    for t in timers:
        t.stages = list(stages)
    assert timers[1].report() == timers[0].report()
    assert timers[1].as_dict() == timers[0].as_dict() == dict(stages)
    assert timers[1].report().splitlines()[-1] == "  total: 1.624s"


def test_stage_timer_times_and_fences_cpu_tensors():
    timer = profiling.StageTimer()
    x = torch.ones(4)
    with timer.stage("tensor", fence=x):
        x = x * 2
    with timer.stage("list", fence=[x, x + 1]):
        pass
    with timer.stage("dict", fence={"a": x, "n": 3}):
        pass
    assert [name for name, _ in timer.stages] == ["tensor", "list", "dict"]
    assert all(dt >= 0 for _, dt in timer.stages)
    off = profiling.StageTimer(enabled=False)
    with off.stage("skipped", fence=x):
        pass
    assert off.stages == [] and off.report() == "  total: 0.000s"


def test_trace_writes_the_annotated_region(tmp_path):
    with profiling.trace(tmp_path) as prof:
        with profiling.annotate("decode_region"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "decode_region" in names
    assert any(e.name == "decode_region" for e in prof.events())


def test_device_split_refuses_a_trace_without_device_events(tmp_path):
    with profiling.trace(tmp_path) as prof:
        with profiling.annotate("step"):
            torch.randn(32, 32).sum()
    with pytest.raises(RuntimeError, match="no device event"):
        profiling.device_split(prof)


def test_union_of_intervals():
    assert profiling._union_us([]) == 0.0
    assert profiling._union_us([(5, 7), (0, 2), (1, 3), (6, 10)]) == 8.0


def test_count_flops_counts_matmuls_and_the_plain_twin_on_the_cpu():
    with profiling.count_flops() as fc:
        torch.randn(8, 16) @ torch.randn(16, 32)
    assert fc.torch_flops == 2 * 8 * 16 * 32 and fc.kernel_flops == {} and fc.total == 8192
    # on the CPU K1 runs its plain twin, whose matmuls the counter sees:
    # step_cost less the elementwise terms (TH + 5T + 2TE + 16H per row)
    words, beam, t, h, e, v = 3, 2, 5, 16, 8, 11
    g = torch.Generator().manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g)
    r = words * beam
    args = (rn(words, t, e), rn(words, t, h), rn(r, h), rn(r, h),
            torch.randint(0, v, (r,), generator=g, dtype=torch.int32),
            rn(h, h), rn(h), rn(h), rn(e + v, 4 * h), rn(h, 4 * h), rn(4 * h))
    with profiling.count_flops() as fc:
        k1.attention_step(*args, beam=beam)
    flops, _ = k1.step_cost(words, r, t, h, e, 0)
    assert fc.kernel_flops == {}
    assert fc.torch_flops == flops - r * (t * h + 5 * t + 2 * t * e + 16 * h)
    assert k1.flop_calls is None


def test_count_flops_adds_the_kernels_own_counts(monkeypatch):
    """On the card the wrappers leave their launches' costs for the count:
    K1 its steps' FLOPs, K2 its pairs and live counts, read after the
    block."""
    from manuscript_tpu_torch.ops import quad_iou as k2

    with profiling.count_flops() as fc:
        k1.flop_calls.append(k1.step_cost(4, 32, 8, 64, 64, 0)[0])
        k2.flop_calls.append((100, torch.tensor([10, 60], dtype=torch.int32)))
        k2.flop_calls.append((30, None))
    assert fc.kernel_flops == {
        "attention_step": float(k1.step_cost(4, 32, 8, 64, 64, 0)[0]),
        # two pages of 50 pairs: 10 live and all 50 (60 clamped), then 30
        "quad_iou": float((10 + 50 + 30) * k2.OPS_PER_PAIR),
    }
    assert k1.flop_calls is None and k2.flop_calls is None
    assert np.isclose(fc.total, sum(fc.kernel_flops.values()))
