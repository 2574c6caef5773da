"""High-throughput OCR over many pages.

The port's counterpart of ``examples/batch_infer.py``: pages go through
``Pipeline.process_batch`` (``FusedOCR.predict_many``), ``batch_pages``
pages per device pass, with the next chunk prepared on the host while the
card computes the current one. Weights as in ``pipeline_infer.py``
(``--east``/``--trba``, ``--quality``, the cache, or random with
``MANUSCRIPT_TPU_ALLOW_RANDOM_INIT=1``). Runs on the CUDA card unless
``--cpu`` is given:

    python examples/torch_port/batch_infer.py page1.jpg page2.jpg ...
    python examples/torch_port/batch_infer.py --glob 'scans/*.png'
"""

import argparse
import glob
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main(argv=None):
    from manuscript_tpu_torch import EAST, TRBA, Pipeline
    from manuscript_tpu_torch.utils.device import add_cpu_flag, card_name, script_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*")
    ap.add_argument("--glob", help="glob of page images")
    ap.add_argument("--east", help="EAST weights (.msgpack or reference .pth)")
    ap.add_argument("--trba", help="TRBA weights (.msgpack or reference .pth)")
    ap.add_argument("--quality", action="store_true", help="the committed micro checkpoints")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    paths = sorted(glob.glob(args.glob)) if args.glob else list(args.paths)
    if not paths:
        print(__doc__)
        return []
    dev = script_device(args.cpu)

    if args.quality:
        from manuscript_tpu_torch.utils.quality import load_quality_models

        east, trba = load_quality_models(dev)
    else:
        east, trba = EAST(args.east, device=dev), TRBA(args.trba, device=dev)
    pipeline = Pipeline(east, trba, device=dev, mode="greedy", batch_pages=4)
    pipeline.predict(paths[0])  # cuDNN plans, word capacity

    t0 = time.perf_counter()
    pages = pipeline.process_batch(paths)
    dt = time.perf_counter() - t0
    for path, page in zip(paths, pages):
        n = sum(len(b.words) for b in page.blocks)
        first = pipeline.get_text(page).split("\n")[0][:60]
        print(f"{path}: {n} words | {first}")
    print(f"\n{len(paths)} pages in {dt:.2f}s = {len(paths) / dt:.2f} pages/s on {card_name(dev)}")
    return pages


if __name__ == "__main__":
    main()
