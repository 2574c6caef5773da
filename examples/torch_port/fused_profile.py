"""Device milliseconds per stage of the page program, from a profiler trace.

The port's counterpart of ``examples/fused_profile.py``. The JAX script cuts
its compiled program after each stage; the port runs eagerly, so the stages
are profiler regions inside the program itself (``utils/profiling.
annotate``), read with ``utils.profiling.device_split``: phase A's
``fused.east_forward``, ``fused.decode`` (decode and compaction),
``fused.nms`` (the parallel LANMS, K2) and ``fused.postprocess``; phase B's
``trba.encode`` and ``trba.decode`` (K1); ``crops`` is the rest of the page
program (word selection and the device crop gather). The program is the
device-crop path's (``FusedOCR._page_program``, crop_scale 1) on one chunk
of 4 bench pages uploaded once, at full width with random weights from a
seed (``bench.models``: EAST resnet50 at 1280², TRBA full plan, bfloat16,
the threshold calibrated as the bench does), 3 runs under the profiler
after a warm one, with beam 8 and then greedy decoding. One JSON line per
stage (ms a run). On the CPU (``--cpu``) a trace holds no device time, so
the lines carry the regions' host-clock ms instead
(``utils.profiling.region_host_ms``). ``MANUSCRIPT_TPU_BENCH_SMOKE=1`` runs
the bench's tiny shapes:

    python examples/torch_port/fused_profile.py
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

STAGES = ("fused.east_forward", "fused.decode", "fused.nms", "fused.postprocess",
          "trba.encode", "trba.decode")
RUNS = 3


def stage_ms(prof, cuda: bool) -> dict:
    """{region: ms a run} of the program's regions and its total, device ms
    on the card and host-clock ms on the CPU."""
    from manuscript_tpu_torch.utils.profiling import device_split, region_host_ms

    if cuda:
        regions = {k: v["device_ms"] for k, v in device_split(prof)["regions"].items()}
    else:
        regions = {k: ms for k, (_, ms) in region_host_ms(prof).items()}
    return {k: regions.get(k, 0.0) / RUNS for k in (*STAGES, "probe.page_program")}


def main(argv=None):
    import torch

    from manuscript_tpu_torch import bench
    from manuscript_tpu_torch.fused import FusedOCR
    from manuscript_tpu_torch.utils.device import add_cpu_flag, card_name, script_device
    from manuscript_tpu_torch.utils.profiling import annotate, trace

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    smoke = bench.is_smoke()
    dev, east, trba, pages = bench.models(smoke, script_device(args.cpu))
    device, cuda = card_name(dev), dev.type == "cuda"
    fused = FusedOCR(east, trba, max_words=16 if smoke else "auto", crop_source="device")
    thresh, _ = bench.calibrate(fused, pages[0])
    _, host, _, sx, sy, _ = fused._prepare_chunk(pages[:4])
    stack = fused._upload(host)
    sx, sy = torch.from_numpy(sx).to(dev), torch.from_numpy(sy).to(dev)
    print(json.dumps({"target": east.target_size, "pages": int(stack.shape[0]),
                      "max_words": fused.max_words, "max_boxes": east.max_boxes,
                      "thresh": round(float(thresh), 4), "device": device}), flush=True)

    lines = []
    for mode in ("beam", "greedy"):
        fused.mode = mode

        def program():
            with annotate("probe.page_program"):
                fused._page_program(stack, None, sx, sy)

        with torch.inference_mode():
            program()  # warm
            with tempfile.TemporaryDirectory() as logdir, trace(logdir) as prof:
                for _ in range(RUNS):
                    program()
        ms = stage_ms(prof, cuda)
        total = ms.pop("probe.page_program")
        ms["crops"] = total - sum(ms.values())
        unit = "device_ms" if cuda else "host_ms"
        for name, v in ms.items():
            line = {"stage": name, "mode": mode, unit: round(v, 4),
                    "share": round(v / total, 4) if total > 0 else None, "device": device}
            print(json.dumps(line), flush=True)
            lines.append(line)
        print(json.dumps({"stage": "page_program", "mode": mode, unit: round(total, 4),
                          "device": device}), flush=True)
    return lines


if __name__ == "__main__":
    main()
