"""Read a ``torch.profiler`` Chrome trace: the device's operations, its busy
time, its idle gaps and what the host was doing in them, and the device
work launched inside each annotated region.

The benchmark's own reader, modelled on ``device_split`` of
``manuscript_tpu_torch/utils/profiling.py`` (whose arithmetic it repeats on
the exported trace, so that the program can change its reader without
moving this one).

Device operations are the events of category ``kernel``, ``gpu_memcpy``
and ``gpu_memset``. A region is a host ``user_annotation`` event
(``record_function``); the device work a region launched is that of the
runtime calls (category ``cuda_runtime`` or ``cuda_driver``) that its
thread made inside its span, joined to their device operations by the
trace's ``correlation`` id.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Span:
    name: str
    start: float  # µs
    end: float
    tid: object = None


@dataclass
class Trace:
    """The parts of a trace the metrics read, times in µs."""

    device: List[Span] = field(default_factory=list)
    regions: List[Span] = field(default_factory=list)
    host_ops: List[Span] = field(default_factory=list)
    launches: List[Tuple[float, object, int]] = field(default_factory=list)  # (ts, tid, corr)
    device_by_corr: Dict[int, List[Span]] = field(default_factory=dict)

    def region_spans(self, name: str) -> List[Span]:
        return [r for r in self.regions if r.name == name]

    def window(self, name: str) -> Optional[Tuple[float, float]]:
        """(start, end) of the one region ``name``, or None."""
        spans = self.region_spans(name)
        if not spans:
            return None
        return min(s.start for s in spans), max(s.end for s in spans)

    def device_in(self, start: float, end: float) -> List[Span]:
        return [d for d in self.device if d.end > start and d.start < end]

    def launched_in(self, region: str) -> List[Span]:
        """The device operations launched inside the spans of ``region``."""
        out = []
        spans = self.region_spans(region)
        for ts, tid, corr in self.launches:
            if any(s.tid == tid and s.start <= ts <= s.end for s in spans):
                out.extend(self.device_by_corr.get(corr, ()))
        return out


def load(source: Union[str, Path, dict]) -> Trace:
    """A Chrome trace (a path, or the parsed JSON) → ``Trace``."""
    doc = source if isinstance(source, dict) else json.loads(Path(source).read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    tr = Trace()
    by_corr = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        start = float(e["ts"])
        span = Span(e.get("name", ""), start, start + float(e.get("dur", 0.0)),
                    (e.get("pid"), e.get("tid")))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            tr.device.append(span)
            if corr is not None:
                by_corr[int(corr)].append(span)
        elif cat == "user_annotation":
            tr.regions.append(span)
        elif cat in LAUNCH_CATS:
            if corr is not None:
                tr.launches.append((start, span.tid, int(corr)))
        elif cat in ("cpu_op", "python_function"):
            tr.host_ops.append(span)
    tr.device_by_corr = dict(by_corr)
    return tr


def union_us(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, start, end = 0.0, None, None
    for a, b in sorted(spans):
        if end is not None and a <= end:
            end = max(end, b)
            continue
        if end is not None:
            total += end - start
        start, end = a, b
    return total + (0.0 if end is None else end - start)


def busy_us(tr: Trace, start: float, end: float) -> float:
    """µs of [start, end] in which the device ran anything, streams merged."""
    return union_us([(max(d.start, start), min(d.end, end)) for d in tr.device_in(start, end)])


def device_ops(tr: Trace, start: float, end: float, top: int = 10) -> List[List]:
    """[[name, seconds]] of the device operations that took most time."""
    by_name: Dict[str, float] = defaultdict(float)
    for d in tr.device_in(start, end):
        by_name[d.name] += (min(d.end, end) - max(d.start, start)) / 1e6
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def _innermost(spans: List[Span], t: float) -> Optional[Span]:
    inside = [s for s in spans if s.start <= t < s.end]
    return min(inside, key=lambda s: s.end - s.start) if inside else None


def idle_gaps(tr: Trace, start: float, end: float, top: int = 10) -> List[List]:
    """[[label, seconds]] of the longest stretches of [start, end] with no
    device operation, each labelled by the innermost region, and the
    innermost host operation, that were open on the host when it began."""
    merged: List[List[float]] = []
    for a, b in sorted((max(d.start, start), min(d.end, end)) for d in tr.device_in(start, end)):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    edges = [start] + [x for ab in merged for x in ab] + [end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:top]:
        region = _innermost(tr.regions, a)
        op = _innermost(tr.host_ops, a)
        label = "/".join(x.name for x in (region, op) if x is not None) or "no host event"
        out.append([label, (b - a) / 1e6])
    return out


def idle_percent(tr: Trace, start: float, end: float) -> Optional[float]:
    """The share of [start, end], in %, in which no kernel, copy or memset
    ran on any stream; None for a trace with no device operation."""
    if not tr.device or end <= start:
        return None
    return 100.0 * (1.0 - busy_us(tr, start, end) / (end - start))
