"""Stage seconds of the native-crop pipeline (``FusedOCR.predict_many``).

The port's counterpart of ``examples/native_stage_probe.py``: one
``predict_many`` over 24 bench pages (2560×1920, ``bench.build_page``) at
full width with random weights from a seed (EAST resnet50 at 1280², 4096
candidates, TRBA full plan, beam 8, both bfloat16; the geometry made
word-sized and the threshold calibrated as the bench does), after one warm
run; then each stage's host-clock seconds from ``FusedOCR.chunk_timings``:
``prep`` (prep thread), ``detect`` (phase A's launch), ``crops`` (the box
fetch and the host crops), ``recognize`` (phase B's launch) and ``finish``
(the text fetch and the page build), summed over the chunks and their
median. ``MANUSCRIPT_TPU_BENCH_SMOKE=1`` runs the bench's tiny shapes.
Runs on the CUDA card unless ``--cpu`` is given:

    python examples/torch_port/native_stage_probe.py [--pages 48]
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

STAGES = ("prep", "detect", "crops", "recognize", "finish")


def main(argv=None):
    from manuscript_tpu_torch import bench
    from manuscript_tpu_torch.fused import FusedOCR
    from manuscript_tpu_torch.utils.device import add_cpu_flag, card_name, script_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pages", type=int, default=24)
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    smoke = bench.is_smoke()
    dev, east, trba, pages = bench.models(smoke, script_device(args.cpu))
    device = card_name(dev)
    pages = [pages[i % len(pages)] for i in range(4 if smoke else args.pages)]
    fused = FusedOCR(east, trba, mode="beam", max_words=16 if smoke else "auto")
    bench.calibrate(fused, pages[0])
    fused.predict_many(pages)  # warm: cuDNN plans, the word capacity

    t0 = time.perf_counter()
    fused.predict_many(pages)
    dt = time.perf_counter() - t0
    chunks = fused.chunk_timings
    print(json.dumps({"pages": len(pages), "chunks": len(chunks), "seconds": round(dt, 4),
                      "pages_per_sec": round(len(pages) / dt, 4),
                      "slots": chunks[0]["slots"], "device": device}), flush=True)
    lines = []
    for name in STAGES:
        times = [c[name] for c in chunks]
        line = {"stage": name, "n": len(times), "sum_s": round(sum(times), 4),
                "median_ms": round(statistics.median(times) * 1e3, 3), "device": device}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
