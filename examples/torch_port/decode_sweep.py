"""Decode-hyperparameter sweep: maximize recognition accuracy over mode /
beam_size / alpha / temperature with ``utils.sweep.Study`` (the reference's
Optuna workflow, built in).

The port's counterpart of ``examples/decode_sweep.py``; weights as in
``pipeline_infer.py`` (``--weights``, ``--quality``, the cache, or random
with ``MANUSCRIPT_TPU_ALLOW_RANDOM_INIT=1``); ``N_TRIALS`` trials (30),
stored in ``decode_sweep_study.json`` in the working directory (resumable).
Runs on the CUDA card unless ``--cpu`` is given:

    python examples/torch_port/decode_sweep.py val/labels.tsv val/images
"""

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main(argv=None):
    from manuscript_tpu_torch.recognizers import TRBA
    from manuscript_tpu_torch.train.metrics import compute_accuracy
    from manuscript_tpu_torch.train.trba_dataset import read_label_file
    from manuscript_tpu_torch.utils.device import add_cpu_flag, card_name, script_device
    from manuscript_tpu_torch.utils.sweep import Study

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("gt_tsv", nargs="?", default="val/labels.tsv")
    ap.add_argument("img_root", nargs="?", default="val/images")
    ap.add_argument("--weights", help="TRBA weights (.msgpack or reference .pth)")
    ap.add_argument("--quality", action="store_true", help="the committed micro checkpoint")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    n_trials = int(os.environ.get("N_TRIALS", "30"))
    dev = script_device(args.cpu)

    paths, refs = [], []
    for name, text in read_label_file(args.gt_tsv):
        p = os.path.join(args.img_root, name)
        if os.path.exists(p):
            paths.append(p)
            refs.append(text)

    if args.quality:
        from manuscript_tpu_torch.utils.quality import load_quality_models

        model = load_quality_models(dev)[1]
    else:
        model = TRBA(args.weights, device=dev)
    print(f"device: {card_name(dev)}; {len(paths)} crops, {n_trials} trials")

    def objective(params):
        if params["mode"] == "greedy":
            results = model.predict(paths, mode="greedy")
        else:
            results = model.predict(
                paths, mode="beam", beam_size=params["beam_size"], alpha=params["alpha"],
                temperature=params["temperature"],
            )
        acc = compute_accuracy(refs, [r["text"] for r in results])
        print(f"trial {params} → acc={acc:.4f}")
        return acc

    study = Study(
        space={
            "mode": ("cat", ["greedy", "beam"]),
            "beam_size": ("int", 2, 12),
            "alpha": ("float", 0.0, 1.0),
            "temperature": ("float", 0.7, 2.0),
        },
        storage="decode_sweep_study.json",
        direction="maximize",
    )
    best = study.optimize(objective, n_trials)
    print(f"best: {best}")
    return best


if __name__ == "__main__":
    main()
