"""Tracing and profiling (counterpart of ``manuscript_tpu/utils/profiling.py``).

``StageTimer`` keeps the JAX module's stage timer and its text format; its
fence synchronises the CUDA device of the tensors it is given, where the JAX
module calls ``jax.block_until_ready``, so that asynchronous launches do not
hide device time. ``trace()`` wraps ``torch.profiler`` (CPU and CUDA
activities, CPU only without a card) and writes a Chrome trace, viewable in
TensorBoard's profiler plugin or Perfetto, where the JAX module wraps
``jax.profiler``; ``annotate()`` names a region in that trace and, on a
card, in NVTX. Two helpers have no JAX counterpart: ``device_split`` reads
a finished trace's device time by kernel and by region, and ``count_flops``
counts the FLOPs of the work run inside it, the hand-written kernels'
included.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

import torch


def _synchronize(fence) -> None:
    """Wait for the CUDA devices of the tensors in ``fence`` (a tensor, or a
    list, tuple or dict of them); CPU tensors need no wait."""
    if isinstance(fence, dict):
        fence = list(fence.values())
    elif isinstance(fence, torch.Tensor):
        fence = [fence]
    for dev in {t.device for t in fence if isinstance(t, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulating wall-clock stage timer with optional device fencing.
    Stages are timed with ``time.perf_counter`` (the JAX module uses
    ``time.time``); the report's format is the JAX module's."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stages: List[tuple] = []

    @contextlib.contextmanager
    def stage(self, name: str, fence=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                _synchronize(fence)
            if self.enabled:
                self.stages.append((name, time.perf_counter() - t0))

    def report(self) -> str:
        total = sum(dt for _, dt in self.stages)
        lines = [f"  {name}: {dt:.3f}s" for name, dt in self.stages]
        lines.append(f"  total: {total:.3f}s")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return {name: dt for name, dt in self.stages}


@contextlib.contextmanager
def trace(logdir: Union[str, Path]):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) → the profile, for ``device_split``.
    On exit a Chrome trace ``<host>_<pid>.<ns>.pt.trace.json`` is written
    into ``logdir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    Path(logdir).mkdir(parents=True, exist_ok=True)
    handler = tensorboard_trace_handler(str(logdir))
    with profile(activities=activities, on_trace_ready=handler) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the profiler's trace (``record_function``) and, on a
    card, an NVTX range of the same name."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def _union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, start, end = 0.0, None, None
    for a, b in sorted(intervals):
        if end is not None and a <= end:
            end = max(end, b)
            continue
        if end is not None:
            total += end - start
        start, end = a, b
    return total + (0.0 if end is None else end - start)


def _launches_under(event) -> int:
    """Device operations launched by ``event`` and the CPU events under it."""
    return len(event.kernels) + sum(_launches_under(ch) for ch in event.cpu_children)


def device_split(prof) -> Dict[str, object]:
    """What a finished ``trace()`` put on the card:

    * ``kernels``: {name: (count, device ms)} of every kernel, copy and
      memset, largest first;
    * ``regions``: {annotate name: {"count", "launches", "device_ms"}}: the
      region's occurrences and the device work launched inside them (by the
      profiler's launch-to-kernel correlation, summed over occurrences);
    * ``launches``: the count of device operations;
    * ``device_ms``: their device time; ``window_ms``: the trace's span
      from its first to its last event; ``busy``: the share of that
      window in which the card ran anything (all streams merged).

    Raises when the trace holds no device event (a CPU-only profile, or a
    card whose profiler records none): a split of zeros would read as an
    idle card."""
    events = prof.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    # a region's span on the device timeline is an annotation, not device work
    device = [e for e in events if e.device_type == cuda and not e.is_user_annotation]
    if not device:
        raise RuntimeError(
            "device_split: the trace holds no device event; time the regions with CUDA "
            "events instead"
        )
    kernels: Dict[str, list] = {}
    for e in device:
        row = kernels.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += (e.time_range.end - e.time_range.start) / 1e3
    regions: Dict[str, Dict[str, float]] = {}
    for e in events:
        if e.device_type == cpu and e.is_user_annotation:
            row = regions.setdefault(e.name, {"count": 0, "launches": 0, "device_ms": 0.0})
            row["count"] += 1
            row["launches"] += _launches_under(e)
            row["device_ms"] += e.device_time_total / 1e3
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    busy = _union_us([(e.time_range.start, e.time_range.end) for e in device])
    return {
        "kernels": {k: (n, ms) for k, (n, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1])},
        "regions": regions,
        "launches": len(device),
        "device_ms": sum(ms for _, ms in kernels.values()),
        "window_ms": window / 1e3,
        "busy": busy / window if window > 0 else 0.0,
    }


class FlopCount:
    """FLOPs of the work run inside ``count_flops()``: ``torch_flops`` from
    torch's ``FlopCounterMode`` (convolutions, matmuls and their backward
    passes), ``kernel_flops`` {kernel: FLOPs} from the hand-written kernels'
    own counts, which the counter cannot see (they launch through ctypes)."""

    def __init__(self):
        self.torch_flops = 0
        self.kernel_flops: Dict[str, float] = {}

    @property
    def total(self) -> float:
        return float(self.torch_flops) + sum(self.kernel_flops.values())


@contextlib.contextmanager
def count_flops():
    """Count the FLOPs of the block → a ``FlopCount``, filled on exit. On the
    card K1 and K2 add their own counts (``attention_step.step_cost``,
    ``quad_iou.call_flops``; K2's live pairs are read after the block); on
    the CPU their plain twins run, and the counter sees the twins' matmuls."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops import attention_step, quad_iou

    result = FlopCount()
    attention_step.flop_calls, quad_iou.flop_calls = [], []
    try:
        with FlopCounterMode(display=False) as mode:
            yield result
        k1_calls, k2_calls = attention_step.flop_calls, quad_iou.flop_calls
    finally:
        attention_step.flop_calls = quad_iou.flop_calls = None
    result.torch_flops = mode.get_total_flops()
    if k1_calls:
        result.kernel_flops["attention_step"] = float(sum(k1_calls))
    if k2_calls:
        result.kernel_flops["quad_iou"] = float(sum(quad_iou.call_flops(*c) for c in k2_calls))
