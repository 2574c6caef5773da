"""Sustained reference-scale training on one CUDA card.

The port's counterpart of ``examples/train_at_scale.py``: the trainers'
steps at the reference's shapes, for ``--steps`` consecutive steps (300)
with a falling loss and a working checkpoint/resume, on synthetic data
(``utils.synthetic`` pages and words, the generators of the micro
checkpoints):

* EAST: resnet50, bfloat16 autocast (float32 weights and loss), 1024²,
  batch 8, ASAM + OHEM + focal geometry + EMA, rasterized score/geometry
  maps (``train/east_train.train_step`` on an ``EASTTrainState``);
* TRBA: hidden 256, the 194-token charset, batch 128, 32×128 crops,
  max_len 40, bfloat16 autocast, teacher-forced CE, clip 5 + Adam
  (``train/trba_train.train_step``).

The host builds each batch (numpy augmentation and rasterization, as the
JAX script's loop does); ``Prefetch`` builds the next batches on worker
threads while the card runs the current step.

Each part prints one JSON line with steps/s, the loss trajectory's ends
and the peak memory, saves a step-indexed checkpoint
(``train/checkpoints.OrbaxCheckpointer``) at the mid-run step, restores it
into fresh modules and optimizer state and trains ``max(10, steps // 10)``
steps more. The exit code is non-zero when a loss does not fall (mean of
the last fifth against the first) or the resumed run is not finite and
below the first fifth's mean. Every line names the card.

Usage::

    python examples/torch_port/train_at_scale.py                 # card, 300 steps each
    python examples/torch_port/train_at_scale.py --steps 40
    MANUSCRIPT_TPU_BENCH_SMOKE=1 python examples/torch_port/train_at_scale.py --cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


class Prefetch:
    """Batches built ahead by ``workers`` threads: batch s by
    ``make(s % workers, s)`` (each worker index owns a dataset copy, with its
    own augmentation stream), and batch s + workers is queued only once
    batch s is taken, so no copy builds two batches at once."""

    def __init__(self, make, workers: int):
        self.make, self.workers = make, workers
        self.pool = ThreadPoolExecutor(workers)
        self.pending = deque(self.pool.submit(make, s % workers, s) for s in range(workers))
        self.next = workers

    def __call__(self):
        batch = self.pending.popleft().result()
        self.pending.append(self.pool.submit(self.make, self.next % self.workers, self.next))
        self.next += 1
        return batch

    def close(self) -> None:
        self.pool.shutdown(cancel_futures=True)


def loader_workers() -> int:
    """Threads for the host's batches: the cores but two (the launching
    thread and the rest of the process), at least one."""
    return max(1, min(6, (os.cpu_count() or 1) - 2))


def emit(metric, **extra):
    print(json.dumps({"metric": metric, **extra}), flush=True)


def peak_gib(dev) -> float | None:
    import torch

    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None


def check_descent(name, losses, resumed, device) -> bool:
    """The JAX script's check: the last fifth's mean below the first's, and
    the resumed losses finite with a mean below the first fifth's."""
    k = max(3, len(losses) // 5)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    resumed = np.asarray(resumed)
    descended = last < first
    resumed_ok = bool(np.isfinite(resumed).all() and float(np.mean(resumed)) < first)
    emit(name, loss_first=round(first, 4), loss_last=round(last, 4), descended=descended,
         resumed_mean=round(float(np.mean(resumed)), 4), resumed_ok=resumed_ok, device=device)
    return descended and resumed_ok


def timed_run(step, batches, n: int, dev, on_step=None):
    """``n`` steps → (losses, steps/s after the first step). The losses stay
    on the card until the end: nothing waits for it inside the loop."""
    import torch

    losses, t0 = [], None
    for s in range(n):
        losses.append(step(*batches(), s))
        if s == 0:
            float(losses[0])  # the first step's start-up is left out of the rate
            t0 = time.perf_counter()
        if on_step is not None:
            on_step(s)
    losses = torch.stack(losses).float().cpu().numpy()
    return losses, (n - 1) / (time.perf_counter() - t0) if n > 1 else 0.0


def east_part(dev, smoke: bool, steps: int, device: str) -> bool:
    import torch

    from manuscript_tpu_torch.models.east import EASTModel
    from manuscript_tpu_torch.train import east_train
    from manuscript_tpu_torch.train.checkpoints import OrbaxCheckpointer
    from manuscript_tpu_torch.train.east_dataset import EASTDataset
    from manuscript_tpu_torch.train.optim import build_east_optimizer
    from manuscript_tpu_torch.utils.synthetic import build_page_dataset
    from manuscript_tpu_torch.utils.weights import init_random_

    side, bsz = (128, 2) if smoke else (1024, 8)
    backbone = "resnet50-tiny" if smoke else "resnet50"
    with tempfile.TemporaryDirectory() as td:
        coco, img_dir, _ = build_page_dataset(Path(td) / "pages", n_pages=4 if smoke else 24, seed=0)
        workers = loader_workers()
        copies = [EASTDataset(img_dir, coco, target_size=side, augment=True, seed=w)
                  for w in range(workers)]

        def make(w, s):
            ds = copies[w]
            items = [ds[int(i)] for i in np.random.default_rng((0, s)).integers(0, len(ds), bsz)]
            return [np.stack([it[j] for it in items]) for j in range(3)]

        prefetch = Prefetch(make, workers)

        def batches():
            return tuple(torch.from_numpy(a).to(dev) for a in prefetch())

        def fresh():
            model = init_random_(EASTModel(backbone), 0).to(dev)
            trainable = dict(model.named_parameters())
            tx, _ = build_east_optimizer(1e-3, steps_per_epoch=100, use_sam=True)
            ema = {k: p.detach().clone() for k, p in trainable.items()}
            return east_train.EASTTrainState(model, tx.init(trainable), ema), tx, trainable

        def stepper(state, tx, trainable):
            def step(img, score, geo, s):
                with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=not smoke):
                    return east_train.train_step(
                        state, tx, trainable, img, score, geo, use_sam=True, sam_adaptive=True,
                        use_ohem=True, ohem_ratio=0.5, use_focal_geo=True, focal_gamma=2.0,
                    )
            return step

        def tree(state):
            return {"model": dict(state.model.state_dict()), "opt": state.opt_state,
                    "ema": state.ema}

        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        state, tx, trainable = fresh()
        ckpt = OrbaxCheckpointer(str(Path(td) / "ckpt"), max_to_keep=2)
        losses, sps = timed_run(
            stepper(state, tx, trainable), batches, steps, dev,
            on_step=lambda s: s == steps // 2 and ckpt.save(s, tree(state), wait=True),
        )
        emit("east_scale_train", steps=steps, steps_per_sec=round(sps, 4),
             peak_gib=peak_gib(dev), device=device,
             config=f"{side}^2 batch {bsz} {backbone} {'f32' if smoke else 'bf16 autocast'} "
                    "ASAM+OHEM+focal+EMA, real rasterized maps")

        # resume: the mid-run state into fresh modules and optimizer state
        state2, tx2, _ = fresh()
        restored = ckpt.restore(tree(state2))
        state2.model.load_state_dict(restored["model"])
        state2.opt_state, state2.ema = restored["opt"], restored["ema"]
        trainable2 = dict(state2.model.named_parameters())
        resumed, _ = timed_run(stepper(state2, tx2, trainable2), batches, max(10, steps // 10), dev)
        prefetch.close()
        return check_descent("east_scale_loss", losses, resumed, device)


def trba_part(dev, smoke: bool, steps: int, device: str) -> bool:
    import torch

    from manuscript_tpu_torch.models.trba import TRBAModel
    from manuscript_tpu_torch.recognizers.charset import default_charset, pack_targets
    from manuscript_tpu_torch.train import optim, trba_train
    from manuscript_tpu_torch.train.checkpoints import OrbaxCheckpointer
    from manuscript_tpu_torch.train.trba_dataset import OCRDataset
    from manuscript_tpu_torch.utils.synthetic import build_word_dataset
    from manuscript_tpu_torch.utils.weights import init_random_

    itos = default_charset()
    stoi = {s: i for i, s in enumerate(itos)}
    bsz, max_len, hidden = (8, 8, 32) if smoke else (128, 40, 256)
    plan = "micro" if smoke else "full"
    compute = "float32" if smoke else "bfloat16"
    with tempfile.TemporaryDirectory() as td:
        tsv, root = build_word_dataset(Path(td) / "words", n=64 if smoke else 512, seed=0)
        workers = loader_workers()
        copies = [OCRDataset(tsv, root, stoi, max_len=max_len, img_h=32, img_w=128,
                             augment=True, seed=w) for w in range(workers)]

        def make(w, s):
            ds = copies[w]
            items = [ds[int(i)] for i in np.random.default_rng((1, s)).integers(0, len(ds), bsz)]
            text_in, target_y, _ = pack_targets([t for _, t in items], stoi, max_len)
            return np.stack([im for im, _ in items]), text_in, target_y

        prefetch = Prefetch(make, workers)

        def batches():
            img, text_in, target_y = prefetch()
            return (torch.from_numpy(img).to(dev), torch.from_numpy(text_in).long().to(dev),
                    torch.from_numpy(target_y).long().to(dev))

        tx = optim.chain(optim.clip_by_global_norm(5.0), optim.adam(1e-3))

        def fresh():
            model = init_random_(TRBAModel(len(itos), hidden, cnn_stage_plan=plan), 0).to(dev)
            params = dict(model.named_parameters())
            return model, params, {"opt": tx.init(params)}

        def stepper(model, params, st, seed: int):
            gen = torch.Generator(dev).manual_seed(seed)

            def step(img, tin, ty, s):
                loss, st["opt"] = trba_train.train_step(
                    model, tx, st["opt"], params, {"image": img, "text_in": tin, "target_y": ty},
                    pad_id=stoi["<PAD>"], generator=gen, compute_dtype=compute,
                )
                return loss
            return step

        def tree(model, st):
            return {"model": dict(model.state_dict()), "opt": st["opt"]}

        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        model, params, st = fresh()
        ckpt = OrbaxCheckpointer(str(Path(td) / "ckpt"), max_to_keep=2)
        losses, sps = timed_run(
            stepper(model, params, st, 0), batches, steps, dev,
            on_step=lambda s: s == steps // 2 and ckpt.save(s, tree(model, st), wait=True),
        )
        emit("trba_scale_train", steps=steps, steps_per_sec=round(sps, 4),
             peak_gib=peak_gib(dev), device=device,
             config=f"32x128 batch {bsz} hidden {hidden} classes {len(itos)} len {max_len} "
                    f"{'f32' if smoke else 'bf16 autocast'}, rendered words + aug")

        model2, params2, st2 = fresh()
        restored = ckpt.restore(tree(model2, st2))
        model2.load_state_dict(restored["model"])
        st2["opt"] = restored["opt"]
        resumed, _ = timed_run(stepper(model2, params2, st2, 10_000), batches,
                               max(10, steps // 10), dev)
        prefetch.close()
        return check_descent("trba_scale_loss", losses, resumed, device)


def main(argv=None) -> int:
    from manuscript_tpu_torch.utils.device import add_cpu_flag, card_name, script_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--skip-east", action="store_true")
    ap.add_argument("--skip-trba", action="store_true")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    smoke = os.environ.get("MANUSCRIPT_TPU_BENCH_SMOKE") == "1"
    steps = min(args.steps, 12) if smoke else args.steps
    dev = script_device(args.cpu)
    device = card_name(dev)
    emit("train_at_scale_env", device=device, steps=steps, smoke=smoke)

    ok = True
    if not args.skip_east:
        ok = east_part(dev, smoke, steps, device) and ok
    if not args.skip_trba:
        ok = trba_part(dev, smoke, steps, device) and ok
    emit("train_at_scale_result", ok=ok, device=device)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
