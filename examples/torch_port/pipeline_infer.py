"""Quick-start: full-page OCR with the port's default pipeline.

The port's counterpart of ``examples/pipeline_infer.py``. Weights come from
the cache (``~/.manuscript_tpu``), from explicit paths (``--east``,
``--trba``; the reference's ``.pth`` checkpoints convert on load), from the
committed micro checkpoints (``--quality``), or, with
``MANUSCRIPT_TPU_ALLOW_RANDOM_INIT=1``, from a seed. Runs on the CUDA card
unless ``--cpu`` is given:

    python examples/torch_port/pipeline_infer.py page.jpg [--out vis.png]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main(argv=None):
    from manuscript_tpu_torch import EAST, TRBA, Pipeline
    from manuscript_tpu_torch.utils.device import add_cpu_flag, card_name, script_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("image", nargs="?", default="example/ocr_example_image.jpg")
    ap.add_argument("--east", help="EAST weights (.msgpack or reference .pth)")
    ap.add_argument("--trba", help="TRBA weights (.msgpack or reference .pth)")
    ap.add_argument("--quality", action="store_true", help="the committed micro checkpoints")
    ap.add_argument("--out", default="pipeline_vis.png", help="where the drawn page goes")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    dev = script_device(args.cpu)

    if args.quality:
        from manuscript_tpu_torch.utils.quality import load_quality_models

        pipeline = Pipeline(*load_quality_models(dev), device=dev)
    else:
        pipeline = Pipeline(EAST(args.east, device=dev), TRBA(args.trba, device=dev), device=dev)
    print(f"device: {card_name(dev)}")
    page, vis = pipeline.predict(args.image, vis=True, profile=True)
    print(pipeline.get_text(page))
    vis.save(args.out)
    print(f"visualization saved to {args.out}")
    return page


if __name__ == "__main__":
    main()
