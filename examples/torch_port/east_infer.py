"""Detector demo: detect words, draw them in reading order, time the stages.

The port's counterpart of ``examples/east_infer.py``; weights as in
``pipeline_infer.py`` (``--weights``, ``--quality``, the cache, or random
with ``MANUSCRIPT_TPU_ALLOW_RANDOM_INIT=1``). Runs on the CUDA card unless
``--cpu`` is given:

    python examples/torch_port/east_infer.py page.jpg [--out east_vis.png]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main(argv=None):
    from manuscript_tpu_torch.detectors import EAST
    from manuscript_tpu_torch.utils.device import add_cpu_flag, card_name, script_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("image", nargs="?", default="example/ocr_example_image.jpg")
    ap.add_argument("--weights", help="EAST weights (.msgpack or reference .pth)")
    ap.add_argument("--quality", action="store_true", help="the committed micro checkpoint")
    ap.add_argument("--out", default="east_vis.png")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    dev = script_device(args.cpu)

    if args.quality:
        from manuscript_tpu_torch.utils.quality import load_quality_models

        detector = load_quality_models(dev)[0]
    else:
        detector = EAST(args.weights, device=dev, score_thresh=0.6)
    result = detector.predict(args.image, vis=True, profile=True, sort_reading_order=True)
    page = result["page"]
    n = sum(len(b.words) for b in page.blocks)
    stages = ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in detector.last_timings.items())
    print(f"detected {n} words; stages (host clock) on {card_name(dev)}: {stages}")
    if result["vis_image"] is not None:
        result["vis_image"].save(args.out)
        print(f"visualization saved to {args.out}")
    return result


if __name__ == "__main__":
    main()
