"""Run one cell of ``BENCHMARK.json`` once: set up, measure, check, report.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name:

* ``BENCHMARK.json``'s ``workloads`` entry names the configuration, whose
  ``file`` holds its sizes, and the traffic mix;
* ``perfbench/traffic/<traffic>.json`` holds the mix's parameters and names
  its ``driver``, ``perfbench/drivers/<driver>.py``, which sets up the
  system under test from the configuration and the mix;
* ``perfbench/e2e/<metric>.py`` reads an end-to-end metric from the window,
  ``perfbench/metrics/<metric>.py`` a per-layer metric from the trace.

A driver's ``setup(cell)`` returns a session with ``unit``, ``failed`` (the
timed calls that failed), ``call()`` (one timed call → the work it
completed), ``finish()`` (wait for the device),
``counts()`` (what per-layer readers need of the work: FLOPs and shapes),
``free()`` (drop the program's state) and ``check()`` (the comparison with
the plain reference → ``Check``). A reader's ``read(ctx)`` returns a number,
or None when the run holds nothing for it to read.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import trace as trace_reader
from .window import Window

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    root: Path
    bench: Dict[str, Any]
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    variant: Optional[str] = None  # a control's switch, set by the calibration tool only

    @property
    def name(self) -> str:
        return self.workload["name"]

    def file(self, *parts: str) -> Path:
        return self.root / HERE.name / Path(*parts)


@dataclass
class Check:
    """Each number compared, with its limit: ``(name, value, limit)``; a
    number passes when it is at most its limit."""

    numbers: List[Tuple[str, float, float]] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)  # what the numbers were taken from

    def add(self, name: str, value: float, limit: float) -> None:
        self.numbers.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.numbers) and all(v <= lim for _, v, lim in self.numbers)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {n: {"value": v, "limit": lim} for n, v, lim in self.numbers}


def load_module(path: Path) -> ModuleType:
    """A harness file by path (file names may hold dots, as metrics' do)."""
    if not path.exists():
        raise FileNotFoundError(f"perfbench: no file {path}")
    spec = importlib.util.spec_from_file_location(f"perfbench_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
              device: torch.device, variant: Optional[str] = None) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"perfbench: no workload {name!r} in BENCHMARK.json")
    work = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / HERE.name / "traffic" / f"{work['traffic']}.json").read_text())
    return Cell(root, bench, work, config, traffic, int(seed), float(seconds), bool(trace),
                torch.device(device), variant)


def _metrics_for(cell: Cell, kind: str) -> List[Dict[str, Any]]:
    return [m for m in cell.bench[kind] if "workloads" not in m or cell.name in m["workloads"]]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(session, seconds: float, device: torch.device) -> Window:
    """Closed loop: one call after another until ``seconds`` have passed;
    the window ends when the device has finished the last call."""
    win = Window(session.unit)
    _sync(device)
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        win.work += session.call()
        win.call_seconds.append(time.perf_counter() - t)
        if time.perf_counter() - start >= seconds:
            break
    session.finish()
    win.seconds = time.perf_counter() - start
    return win


@dataclass
class TraceContext:
    """What a per-layer reader reads: the trace, the traced window's span
    in it (µs), the calls made in it, and the session's counts."""

    cell: Cell
    trace: trace_reader.Trace
    start: float
    end: float
    calls: int
    counts: Dict[str, Any]

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e6


def traced(session, cell: Cell, calls: int) -> TraceContext:
    """``calls`` calls under the profiler, inside the region
    ``bench.window``, each inside ``bench.call`` → the parsed trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cell.device.type == "cuda" else [])
    _sync(cell.device)
    with profile(activities=acts) as prof:
        with record_function("bench.window"):
            for _ in range(calls):
                with record_function("bench.call"):
                    session.call()
            session.finish()
    out = cell.root / "build" / "perfbench" / "trace.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    tr = trace_reader.load(out)
    out.unlink()
    span = tr.window("bench.window")
    if span is None:
        raise RuntimeError("perfbench: the trace holds no bench.window region")
    return TraceContext(cell, tr, span[0], span[1], calls, session.counts())


def device_info(cell: Cell) -> Dict[str, Any]:
    dev = cell.device
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": int(cell.workload["chips"]),
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def run(cell: Cell, t0: float) -> Dict[str, Any]:
    """Set up, measure (or trace), check → the result's fields, and the
    window (for its call count)."""
    driver = load_module(cell.file("drivers", f"{cell.traffic['driver']}.py"))
    session = driver.setup(cell)
    gc.collect()
    gc.freeze()  # the set-up's objects stay out of the window's collections
    setup_s = time.perf_counter() - t0
    result: Dict[str, Any] = {}
    metrics: Dict[str, Dict[str, Any]] = {}
    if cell.trace:
        ctx = traced(session, cell, int(cell.traffic["trace_calls"]))
        attempted = ctx.calls
        for m in _metrics_for(cell, "per_layer"):
            value = load_module(cell.file("metrics", f"{m['name']}.py")).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        window = None
    else:
        window = measure(session, cell.seconds, cell.device)
        attempted = window.calls
        for m in _metrics_for(cell, "end_to_end"):
            value = load_module(cell.file("e2e", f"{m['name']}.py")).read(window, setup_s)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = device_info(cell)
    if cell.trace and cell.device.type == "cuda":
        device["busy_s"] = trace_reader.busy_us(ctx.trace, ctx.start, ctx.end) / 1e6
        device["window_s"] = ctx.seconds
        result["breakdown"] = {
            "device_ops": trace_reader.device_ops(ctx.trace, ctx.start, ctx.end),
            "idle_gaps": trace_reader.idle_gaps(ctx.trace, ctx.start, ctx.end),
        }
    session.free()
    check = session.check()
    result.update({"correct": check.correct, "attempted": attempted, "failed": session.failed,
                   "metrics": metrics, "device": device})
    result["checks"] = check.as_dict()  # last: the numbers compared, each with its limit
    return {"result": result, "window": window, "setup_s": setup_s, "check": check}
