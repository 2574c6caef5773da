"""Device milliseconds per stage of EAST's forward at 1280², bfloat16.

The port's counterpart of ``examples/east_stage_probe.py``. The JAX script
gets prefix programs from XLA's dead-code elimination; here the probe wraps
the model's submodules from outside in profiler regions
(``utils/profiling.annotate``) and reads them from a trace with
``utils.profiling.device_split``: ``stem`` (conv1 + bn1), ``layer1`` …
``layer4`` (each stage's bottleneck blocks), ``decoder`` (the merge
decoder) and ``heads`` (score and geometry convolutions); ``rest`` is the
forward's remainder (the stem's ReLU and max-pool, the layout permutes and
the sigmoid). Random weights from a seed, resnet50, one page, 5 forwards
under the profiler after a warm one. One JSON line per stage (ms a
forward). On the CPU (``--cpu``) the lines carry host-clock ms
(``utils.profiling.region_host_ms``). ``MANUSCRIPT_TPU_BENCH_SMOKE=1``
runs resnet50-tiny at 128²:

    python examples/torch_port/east_stage_probe.py
"""

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

RUNS = 5


def wrap(module, name: str) -> None:
    """``module``'s forward inside the profiler region ``name``."""
    from manuscript_tpu_torch.utils.profiling import annotate

    inner = module.forward

    def forward(*args, **kwargs):
        with annotate(name):
            return inner(*args, **kwargs)

    module.forward = forward


def main(argv=None):
    import numpy as np
    import torch

    from manuscript_tpu_torch.models.east import EASTModel
    from manuscript_tpu_torch.utils.device import add_cpu_flag, card_name, script_device
    from manuscript_tpu_torch.utils.profiling import device_split, region_host_ms, trace
    from manuscript_tpu_torch.utils.weights import init_random_

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    smoke = os.environ.get("MANUSCRIPT_TPU_BENCH_SMOKE") == "1"
    dev = script_device(args.cpu)
    device, cuda = card_name(dev), dev.type == "cuda"
    size, backbone = (128, "resnet50-tiny") if smoke else (1280, "resnet50")
    dtype = torch.bfloat16

    model = init_random_(EASTModel(backbone), 0).to(device=dev, dtype=dtype).eval()
    bb = model.backbone
    wrap(bb.conv1, "stem")
    wrap(bb.bn1, "stem")
    for stage, name in bb.names:
        wrap(getattr(bb, name), f"layer{stage + 1}")
    wrap(model.decoder, "decoder")
    wrap(model.score_head, "heads")
    wrap(model.geo_head, "heads")
    wrap(model, "forward")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, size, size, 3),
                                                                  dtype=np.float32))
    x = x.to(device=dev, dtype=dtype)

    with torch.inference_mode():
        model(x)  # warm: cuDNN plans
        with tempfile.TemporaryDirectory() as logdir, trace(logdir) as prof:
            for _ in range(RUNS):
                model(x)
    if cuda:
        regions = {k: v["device_ms"] for k, v in device_split(prof)["regions"].items()}
    else:
        regions = {k: ms for k, (_, ms) in region_host_ms(prof).items()}
    names = ["stem", *[f"layer{i}" for i in range(1, 5)], "decoder", "heads"]
    ms = {k: regions[k] / RUNS for k in names}
    total = regions["forward"] / RUNS
    ms["rest"] = total - sum(ms.values())
    unit = "device_ms" if cuda else "host_ms"
    lines = []
    for name, v in [*ms.items(), ("forward", total)]:
        line = {"stage": name, unit: round(v, 4), "share": round(v / total, 4),
                "config": f"{backbone} {size}^2 bf16", "device": device}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
