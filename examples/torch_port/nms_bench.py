"""A/B benchmark of the locality-aware NMS routes, from candidates resident
on the device to boxes usable on the host.

The port's counterpart of ``examples/nms_bench.py``, at 1k/4k/8k candidates
(128 and 256 in ``MANUSCRIPT_TPU_BENCH_SMOKE=1``):

* ``host_cpp_ms``: the candidates' copy to the host, then the C++ LANMS
  (``ops/lanms.py``, ``csrc/lanms.cpp``), which the classic detector runs;
* ``device_scan_ms``: the scan LANMS on the device (``ops/lanms_torch.
  locality_aware_nms``: the merge walk K3, then the standard NMS's IoUs
  through K2), then the (max_out, 9) boxes' copy to the host
  (``EAST(nms="device")``);
* ``device_parallel_ms``: the parallel LANMS of the page program
  (``locality_aware_nms_parallel``, K2), then the same copy.

Host clock, median of 8 calls after one warm-up; each ends in a host copy,
which waits for the card. One JSON line per candidate count, each naming
the card. Runs on the CUDA card unless ``--cpu`` is given:

    python examples/torch_port/nms_bench.py
"""

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def synth_candidates(n: int, seed: int = 0) -> np.ndarray:
    """Jittered word-like quads over a 1280² page: ~n/8 clusters of 8."""
    rng = np.random.default_rng(seed)
    quads = []
    for _ in range(max(1, n // 8)):
        x0 = float(rng.uniform(0, 1200))
        y0 = float(rng.uniform(0, 1240))
        w, h = float(rng.uniform(30, 120)), float(rng.uniform(12, 40))
        for _ in range(8):
            j = rng.normal(0, 1.5, 8)
            quads.append(np.concatenate([
                np.array([x0, y0, x0 + w, y0, x0 + w, y0 + h, x0, y0 + h]) + j,
                [float(rng.uniform(0.5, 1.0))],
            ]))
    return np.asarray(quads[:n], np.float32)


def timed(fn, n_iters: int = 8) -> float:
    fn()  # warm-up: cuDNN-free, but the kernels' first launch loads them
    times = []
    for _ in range(n_iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main(argv=None):
    import torch

    from manuscript_tpu_torch.ops.lanms import locality_aware_nms as host_lanms
    from manuscript_tpu_torch.ops.lanms_torch import (
        locality_aware_nms as scan_lanms,
        locality_aware_nms_parallel,
    )
    from manuscript_tpu_torch.utils.device import add_cpu_flag, card_name, script_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    dev = script_device(args.cpu)
    device = card_name(dev)
    smoke = os.environ.get("MANUSCRIPT_TPU_BENCH_SMOKE") == "1"
    sizes = (128, 256) if smoke else (1024, 4096, 8192)

    lines = []
    for n in sizes:
        cands = torch.from_numpy(synth_candidates(n)).to(dev)

        def host_path():
            return host_lanms(cands.cpu().numpy().astype(np.float64), 0.2)

        def device_path(nms):
            def run():
                boxes, count = nms(cands, 0.2, max_out=1024)
                count = int(count)
                return boxes[:count].cpu().numpy()
            return run

        scan, parallel = device_path(scan_lanms), device_path(locality_aware_nms_parallel)
        line = {
            "n_candidates": n,
            "host_cpp_ms": round(timed(host_path) * 1e3, 4),
            "device_scan_ms": round(timed(scan) * 1e3, 4),
            "device_parallel_ms": round(timed(parallel) * 1e3, 4),
            "host_boxes": len(host_path()),
            "scan_boxes": len(scan()),
            "parallel_boxes": len(parallel()),
            "device": device,
        }
        line["winner"] = min(("host_cpp", "device_scan", "device_parallel"),
                             key=lambda k: line[f"{k}_ms"])
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
