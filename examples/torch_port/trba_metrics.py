"""Standalone recognizer evaluation: Accuracy / CER / WER / FPS against a
TSV ground truth (filename<TAB>text).

The port's counterpart of ``examples/trba_metrics.py``; weights as in
``pipeline_infer.py`` (``--weights``, ``--quality``, the cache, or random
with ``MANUSCRIPT_TPU_ALLOW_RANDOM_INIT=1``); ``MODE=beam`` decodes by beam
search. Runs on the CUDA card unless ``--cpu`` is given:

    python examples/torch_port/trba_metrics.py val/labels.tsv val/images
"""

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

BATCH = 32


def main(argv=None):
    import torch

    from manuscript_tpu_torch.recognizers import TRBA
    from manuscript_tpu_torch.train.metrics import aggregate_text_metrics
    from manuscript_tpu_torch.train.trba_dataset import read_label_file
    from manuscript_tpu_torch.utils.device import add_cpu_flag, card_name, script_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("gt_tsv", nargs="?", default="val/labels.tsv")
    ap.add_argument("img_root", nargs="?", default="val/images")
    ap.add_argument("--weights", help="TRBA weights (.msgpack or reference .pth)")
    ap.add_argument("--quality", action="store_true", help="the committed micro checkpoint")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    mode = os.environ.get("MODE", "greedy")
    dev = script_device(args.cpu)

    paths, refs = [], []
    for name, text in read_label_file(args.gt_tsv):
        p = os.path.join(args.img_root, name)
        if os.path.exists(p):
            paths.append(p)
            refs.append(text)
    print(f"evaluating {len(paths)} images, mode={mode}")

    if args.quality:
        from manuscript_tpu_torch.utils.quality import load_quality_models

        model = load_quality_models(dev)[1]
    else:
        model = TRBA(args.weights, device=dev)
    model.predict(paths[:BATCH], batch_size=BATCH, mode=mode)  # warm-up
    t0 = time.perf_counter()
    results = model.predict(paths, batch_size=BATCH, mode=mode)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    metrics = aggregate_text_metrics(refs, [r["text"] for r in results])
    metrics["fps"] = len(paths) / dt
    print(
        f"Accuracy: {metrics['accuracy']:.4f}  CER: {metrics['cer']:.4f}  "
        f"WER: {metrics['wer']:.4f}  FPS: {metrics['fps']:.1f} on {card_name(dev)}"
    )
    return metrics


if __name__ == "__main__":
    main()
