"""Train the micro quality checkpoints with the port and evaluate them.

The port's counterpart of ``examples/make_quality_ckpt.py``, the same
recipe on the card: micro TRBA (hidden 64, the SEResNet31 "micro" plan,
32×128 crops, 40 epochs on 3000 rendered words) and micro EAST
(resnet50-micro at 512², ``QUALITY_EAST_EPOCHS`` epochs, 600 by default, on
96 rendered pages, 12 for validation), a score threshold calibrated on two
pages of seed 8000, and the four held-out evaluations (8 pages, seed 9000)
printed beside the JAX-trained pair's numbers in
``manuscript_tpu_torch/configs/quality_reference.json``.

Everything it writes stays inside its workdir: the data, the experiments,
and ``<workdir>/quality/`` with ``east_micro.msgpack``,
``trba_micro.msgpack`` and ``east_micro.json``, which
``utils.quality.load_quality_models(directory=...)`` reads. The committed
checkpoints under ``manuscript_tpu/configs/quality/`` are only read:
``QUALITY_SKIP_TRBA=1`` (or ``QUALITY_SKIP_EAST=1``) copies the committed
TRBA (or EAST) checkpoint instead of training one. Runs on the CUDA card
unless ``--cpu`` is given:

    python examples/torch_port/make_quality_ckpt.py [workdir]

Seeds: training uses 1/2/3, calibration 8000, evaluation 9000.
"""

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from manuscript_tpu_torch.utils.synthetic import (  # noqa: E402
    build_page_dataset,
    build_word_dataset,
    eval_pages,
)

# p_Downscale=0.5: half the training crops are down/re-upsampled to
# 0.4-0.75×, since the fused pipeline crops words from the detector's copy
# of the page and the recognizer must read them at ~2× less resolution
TRBA_CONFIG = dict(
    max_len=12, hidden_size=64, cnn_stage_plan="micro", img_h=32, img_w=128, batch_size=64,
    epochs=40, lr=1e-3, optimizer="adam", scheduler="cosine", val_size=0.1, early_stop=12,
    aug_params={"p_Downscale": 0.5},
)
EVAL_PAGES = 8
EVALUATIONS = (  # (label, evaluate_quality settings, the reference entry beside it)
    ("fused greedy", dict(mode="greedy"), None),
    ("fused beam", dict(mode="beam"), "native"),
    ("fused beam crop_scale=2", dict(mode="beam", crop_scale=2), "crop_scale_2"),
    ("classic host crops", dict(use_fused=False, mode="greedy"), "classic"),
)


def best_checkpoint(exp_dir: str, names) -> Path:
    ckpts = Path(exp_dir) / "checkpoints"
    return next((ckpts / n for n in names if (ckpts / n).exists()), ckpts / names[-1])


def main(argv=None):
    from manuscript_tpu_torch.detectors import EAST
    from manuscript_tpu_torch.recognizers import TRBA
    from manuscript_tpu_torch.utils.device import add_cpu_flag, card_name, script_device
    from manuscript_tpu_torch.utils.quality import (
        QUALITY_DIR,
        evaluate_quality,
        load_quality_models,
        quality_reference,
        score_pages,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?", default="./quality_run")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    dev = script_device(args.cpu)
    device = card_name(dev)
    workdir = Path(args.workdir)
    out_dir = workdir / "quality"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    print(f"device: {device}", flush=True)

    # ---- TRBA micro ----
    if os.environ.get("QUALITY_SKIP_TRBA") == "1":
        shutil.copy(QUALITY_DIR / "trba_micro.msgpack", out_dir / "trba_micro.msgpack")
    else:
        tsv, img_dir = build_word_dataset(workdir / "words", n=3000, seed=1)
        print(f"[data] words built in {time.perf_counter() - t0:.0f}s", flush=True)
        out = TRBA.train(
            tsv, img_dir, device=dev,
            config=dict(TRBA_CONFIG, exp_root=str(workdir / "experiments"), exp_name="trba_micro"),
        )
        print(f"[trba] val_acc={out['val_acc']:.3f} ({time.perf_counter() - t0:.0f}s)", flush=True)
        shutil.copy(best_checkpoint(out["exp_dir"], ("best_acc.msgpack", "last.msgpack")),
                    out_dir / "trba_micro.msgpack")

    # ---- EAST micro ----
    if os.environ.get("QUALITY_SKIP_EAST") == "1":
        shutil.copy(QUALITY_DIR / "east_micro.msgpack", out_dir / "east_micro.msgpack")
    else:
        tr_coco, tr_pages, _ = build_page_dataset(workdir / "pages_train", n_pages=96, seed=2)
        va_coco, va_pages, _ = build_page_dataset(workdir / "pages_val", n_pages=12, seed=3)
        print(f"[data] pages built ({time.perf_counter() - t0:.0f}s)", flush=True)
        # RAdam + Lookahead, not SAM-SGD: the micro model must converge in
        # minutes; the card-resident dataset ships only indices each step
        eout = EAST.train(
            tr_pages, tr_coco, va_pages, va_coco,
            experiment_root=str(workdir / "experiments"), model_name="east_micro",
            backbone="resnet50-micro", target_size=512,
            epochs=int(os.environ.get("QUALITY_EAST_EPOCHS", "600")), batch_size=8, lr=1e-3,
            use_sam=False, use_multiscale=False, freeze_first=False, early_stop=150,
            val_interval=10, log_tensorboard=False, ckpt_interval=20, cache_device=True,
            seed=0, device=dev,
        )
        print(f"[east] best_val_loss={eout['best_val_loss']:.4f} "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)
        shutil.copy(best_checkpoint(eout["exp_dir"], ("best.msgpack", "last.msgpack")),
                    out_dir / "east_micro.msgpack")

    # ---- calibrate score_thresh on two held-out pages: the best detector F1 ----
    # expand 0.52 inverts the 0.3 label shrink (utils/quality.load_quality_models)
    meta = {"backbone": "resnet50-micro", "target_size": 512, "score_thresh": 0.6,
            "expand_ratio": 0.52, "quantization": 1}
    (out_dir / "east_micro.json").write_text(json.dumps(meta, indent=1))
    east, trba = load_quality_models(dev, directory=out_dir)
    cal = eval_pages(2, seed=8000)
    best_t, best_f1 = 0.6, -1.0
    for t in (0.4, 0.5, 0.6, 0.7, 0.8, 0.9):
        east.score_thresh = t
        s = score_pages([east.predict(p)["page"] for p, _ in cal], [g for _, g in cal])
        print(f"[cal] thresh={t}: F1={s['detector_f1']:.3f}", flush=True)
        if s["detector_f1"] > best_f1:
            best_t, best_f1 = t, s["detector_f1"]
    meta.update(score_thresh=best_t, calibration_f1=round(best_f1, 4),
                trained=time.strftime("%Y-%m-%d"), train_seeds=[1, 2, 3], calibration_seed=8000,
                device=device)
    (out_dir / "east_micro.json").write_text(json.dumps(meta, indent=1))
    east.score_thresh = best_t

    # ---- held-out evaluation beside the JAX-trained pair's numbers ----
    ref = quality_reference()
    results = {}
    for label, kw, ref_name in EVALUATIONS:
        m = evaluate_quality(n_pages=EVAL_PAGES, seed=9000, models=(east, trba), **kw)
        results[label] = m
        beside = ("" if ref_name is None else
                  f" | JAX-trained pair ({ref_name}, {ref['args']['mode']}, "
                  f"{ref['args']['n_pages']} pages): F1={ref[ref_name]['detector_f1']:.3f} "
                  f"e2e_CER={ref[ref_name]['e2e_cer']:.3f} word_acc={ref[ref_name]['word_acc']:.3f}")
        print(f"[eval {label}] F1={m['detector_f1']:.3f} e2e_CER={m['e2e_cer']:.3f} "
              f"matched_CER={m['matched_cer']:.3f} word_acc={m['word_acc']:.3f}{beside}", flush=True)
    print(f"done in {time.perf_counter() - t0:.0f}s on {device} → {out_dir}", flush=True)
    return results


if __name__ == "__main__":
    main()
