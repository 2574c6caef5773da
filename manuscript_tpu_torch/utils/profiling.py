"""Tracing and profiling (counterpart of ``manuscript_tpu/utils/profiling.py``).

``StageTimer`` keeps the JAX module's stage timer and its text format; its
fence synchronises the CUDA device of the tensors it is given, where the JAX
module calls ``jax.block_until_ready``, so that asynchronous launches do not
hide device time. ``trace()`` wraps ``torch.profiler`` (CPU and CUDA
activities, CPU only without a card) and writes a Chrome trace, viewable in
TensorBoard's profiler plugin or Perfetto, where the JAX module wraps
``jax.profiler``; ``annotate()`` names a region in that trace and, on a
card, in NVTX (with no profiler recording it costs a flag read). Two
helpers have no JAX counterpart: ``device_split`` reads a finished trace's
device time by kernel and by region (autograd's worker thread counted in
the regions around a backward pass), and ``count_flops``
counts the FLOPs of the work run inside it, the hand-written kernels'
included. ``graph_time_ms`` and ``call_ms`` time one call and ``bound_ms``
gives the least time the card could take for a call's bytes and
operations: ``chip_smoke.py`` and ``examples/torch_port/kernel_bench.py``
time the kernels with them.
"""

from __future__ import annotations

import bisect
import contextlib
import statistics
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional, Union

import torch
from torch.autograd import profiler as _autograd_profiler

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores


def graph_time_ms(fn, calls: int = 20, replays: int = 7) -> float:
    """Device time of one ``fn()`` on the card: a CUDA graph of ``calls``
    back-to-back calls, replayed after warm-up, timed with CUDA events;
    median per call."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def call_ms(fn, device: torch.device, calls: int = 10) -> float:
    """Milliseconds of one ``fn()`` after one warm-up call: on a card, CUDA
    events around ``calls`` back-to-back calls (for work that a CUDA graph
    cannot hold: host waits, library workspaces), their mean; on the CPU
    the host clock's median of ``calls`` calls."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def bound_ms(nbytes: float, flops: float):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    H100's memory rate and the f32 operations over its f32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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


class annotate:
    """``with annotate(name):`` names a region: a ``record_function`` event
    in the profiler's trace while a profiler records (``trace()``,
    ``torch.profiler.profile``), and, once the process has initialised
    CUDA, an NVTX range of the same name for ``nsys``. With no profiler
    active it enters no ``record_function`` and costs a flag read and the
    NVTX push and pop, so regions may sit in hot loops (the CUDA check is
    ``is_initialized``: ``is_available`` costs more than the rest)."""

    __slots__ = ("name", "_event", "_nvtx")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "annotate":
        self._event = None
        if _autograd_profiler._is_profiler_enabled:
            self._event = torch.profiler.record_function(self.name)
            self._event.__enter__()
        self._nvtx = torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._event is not None:
            self._event.__exit__(*exc)
        return False


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


AUTOGRAD_OP = "autograd::engine::evaluate_function"


def autograd_threads(events) -> set:
    """The threads on which autograd's engine ran a backward node: those of
    the events (anything with ``name`` and ``thread``) named
    ``autograd::engine::evaluate_function: …``. On a card the engine runs
    the CUDA backward on a worker thread of its own."""
    return {e.thread for e in events if e.name.startswith(AUTOGRAD_OP)}


def launched_in(span, launches, workers) -> list:
    """The launch rule: of ``launches``, [(thread, time, work)] sorted by
    time, the work launched inside ``span``, (thread, start, end), on the
    span's own thread or on one of ``workers`` (``autograd_threads``), so
    that a region around ``autograd.grad`` holds the backward's kernels."""
    thread, start, end = span
    out = []
    for t, ts, work in launches[bisect.bisect_left(launches, start, key=lambda x: x[1]):]:
        if ts > end:
            break
        if t == thread or t in workers:
            out.append(work)
    return out


def orphan_launches(events, device) -> list:
    """[(thread, start, [kernel])] of the device operations in ``device``
    that no operator's ``kernels`` hold (matched by name and duration): the
    profiler links a kernel to the operator active at its launch, and a
    hand-written kernel launched outside any operator has none. Each is
    placed at its CUDA launch call (a CPU event named ``cu…`` with the
    kernel's correlation ``id``); one with no such call is left out."""
    cpu = torch.autograd.DeviceType.CPU
    held: Dict[tuple, int] = {}
    for e in events:
        if e.device_type == cpu:
            for k in e.kernels:
                held[(k.name, k.duration)] = held.get((k.name, k.duration), 0) + 1
    calls = {e.id: e for e in events if e.device_type == cpu and not e.is_user_annotation
             and e.name.startswith("cu") and getattr(e, "id", None) is not None}
    out = []
    for d in device:
        key = (d.name, d.time_range.end - d.time_range.start)
        if held.get(key, 0) > 0:
            held[key] -= 1
            continue
        call = calls.get(getattr(d, "id", None))
        if call is not None:
            out.append((call.thread, call.time_range.start,
                        [SimpleNamespace(name=d.name, device=0, duration=key[1])]))
    return out


def device_split(prof) -> Dict[str, object]:
    """What a finished ``trace()`` put on the card:

    * ``kernels``: {name: (count, device ms)} of every kernel, copy and
      memset, largest first;
    * ``regions``: {annotate name: {"count", "launches", "device_ms"}}: the
      region's occurrences and the device work launched inside them,
      summed over occurrences. A device operation belongs to a region when
      the operator that launched it (joined by the profiler's
      launch-to-kernel correlation) started inside the region's span, on
      the region's thread or on a thread of autograd's engine
      (``launched_in``): a region around a backward pass counts its
      kernels. One that no operator launched (a hand-written kernel
      launched through ctypes) is joined by its correlation id to its
      CUDA launch call, whose start and thread take the operator's place
      (``orphan_launches``);
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
    annotations = [e for e in events if e.device_type == cpu and e.is_user_annotation]
    names = {e.name for e in annotations}  # nor is a region's span linked to its own event
    launches = sorted([(e.thread, e.time_range.start, [k for k in e.kernels if k.name not in names])
                       for e in events if e.device_type == cpu and e.kernels]
                      + orphan_launches(events, device), key=lambda x: x[1])
    workers = autograd_threads(events)
    regions: Dict[str, Dict[str, float]] = {}
    for e in annotations:
        ops = [k for work in launched_in((e.thread, e.time_range.start, e.time_range.end),
                                         launches, workers) for k in work]
        row = regions.setdefault(e.name, {"count": 0, "launches": 0, "device_ms": 0.0})
        row["count"] += 1
        row["launches"] += len(ops)
        row["device_ms"] += sum(k.duration for k in ops) / 1e3
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


def region_host_ms(prof) -> Dict[str, tuple]:
    """{annotate name: (occurrences, host-clock ms summed over them)} of a
    finished ``trace()``: each region's span on the thread that opened it,
    from its start to its end, whatever ran inside (autograd's worker
    thread included); a CPU-only trace has these where ``device_split`` has
    no device time."""
    out: Dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.is_user_annotation:
            row = out.setdefault(e.name, [0, 0.0])
            row[0] += 1
            row[1] += (e.time_range.end - e.time_range.start) / 1e3
    return {k: tuple(v) for k, v in out.items()}


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
