"""Recognizer demo: beam against greedy decoding throughput on word crops.

The port's counterpart of ``examples/trba_infer.py``; weights as in
``pipeline_infer.py`` (``--weights``, ``--quality``, the cache, or random
with ``MANUSCRIPT_TPU_ALLOW_RANDOM_INIT=1``). Runs on the CUDA card unless
``--cpu`` is given:

    python examples/torch_port/trba_infer.py 'crops/*.png'
"""

import argparse
import glob
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

BATCH = 16


def main(argv=None):
    import torch

    from manuscript_tpu_torch.recognizers import TRBA
    from manuscript_tpu_torch.utils.device import add_cpu_flag, card_name, script_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("crops", nargs="?", default="crops/*.png", help="glob of crop images")
    ap.add_argument("--weights", help="TRBA weights (.msgpack or reference .pth)")
    ap.add_argument("--quality", action="store_true", help="the committed micro checkpoint")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    dev = script_device(args.cpu)

    if args.quality:
        from manuscript_tpu_torch.utils.quality import load_quality_models

        model = load_quality_models(dev)[1]
    else:
        model = TRBA(args.weights, device=dev)
    images = sorted(glob.glob(args.crops))
    if not images:
        print(f"no images matched {args.crops}")
        return {}

    rates = {}
    for mode, kwargs in (
        ("greedy", {}),
        ("beam", dict(beam_size=8, temperature=1.7, alpha=0.9)),
    ):
        model.predict(images[:BATCH], batch_size=BATCH, mode=mode, **kwargs)  # warm-up
        t0 = time.perf_counter()
        results = model.predict(images, batch_size=BATCH, mode=mode, **kwargs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rates[mode] = len(images) / (time.perf_counter() - t0)
        print(f"{mode}: {rates[mode]:.1f} crops/s on {card_name(dev)}")
        for path, r in list(zip(images, results))[:5]:
            print(f"  {path}: {r['text']!r} ({r['confidence']:.3f})")
    return rates


if __name__ == "__main__":
    main()
