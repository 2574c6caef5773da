"""End-to-end benchmark of the port on one CUDA card (counterpart of the
root ``bench.py``, which measures the JAX package and stays its own).

    python -m manuscript_tpu_torch.bench [--perf-gate]
    python -m manuscript_tpu_torch bench
    MANUSCRIPT_TPU_BENCH_SMOKE=1 python -m manuscript_tpu_torch.bench   # CPU self-test

Configurations, pages and metric names are the JAX bench's: ``build_page``
pages of 2560×1920 with 14×8 word blocks; EAST resnet50 at 1280² with 4096
candidates and TRBA with the full plan, both in bfloat16 (the decoder and
K1 stay float32); the Pipeline default, beam 8 / T 1.7 / α 0.9 with
``max_words="auto"``; 24 pages timed as the median of 3 runs. One JSON line
per metric (``{"metric", "value", "unit", "vs_baseline", ...}``), the
primary ``e2e_pipeline_pages_per_sec`` first; every line carries
``"device"``, the card's name and power limit as ``nvidia-smi`` prints them.
``vs_baseline`` divides by the reference's only recorded number, its Colab
EAST-only mean of 0.604 s a page (a CPU-class figure, not a card's).

Weights are random from a seed (no checkpoint is fetched), so two things are
set before the timing, as the JAX bench calibrates its threshold: the
geometry head's bias is a word-sized quad (the port's random init gives
sub-pixel boxes, which no word survives), and ``FusedOCR.calibrate`` picks
the threshold among the first page's score-map quantiles (random scores sit
near 0.5, below every default threshold) for at most 250 words.

MFU is FLOPs a page (or a training step) times pages (steps) a second over
989e12, the H100 SXM dense bfloat16 peak: all FLOPs are divided by that one
peak, though K1 and the decoder run in float32. FLOPs come from
``utils.profiling.count_flops``: torch's ``FlopCounterMode`` over one page
through ``FusedOCR.predict`` (one ``train_step``), plus K1's and K2's own
counts. A share above 1.05 is an error and the run fails; so does any
failing section: nothing here is caught.

The card is local, so the JAX bench's link corrections have no counterpart:
``link_probe_s`` is the pinned host-to-device copy of one page's upload, no
link-normalised line is printed, and ``channel_folded`` is false (the port
uploads the plain uint8 page). Raw timings go to
``build/bench_torch_raw.json``.

``MANUSCRIPT_TPU_BENCH_SMOKE=1`` runs the same code on the CPU at tiny shapes
(``resnet50-tiny`` at 128² with 256 boxes, TRBA ``micro`` at hidden 64 on
32×128 crops for 8 steps, 256×192 pages, 16 word slots, fewer repeats) to
test the harness: its numbers are CPU numbers, not the card's. Without it
the bench needs a card and raises without one.
"""

from __future__ import annotations

import io
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
RAW_PATH = ROOT / "build" / "bench_torch_raw.json"
REFERENCE_PAGES_PER_SEC = 1.0 / 0.604  # the reference's Colab EAST mean, 0.604 s/page
PEAK_FLOPS_BF16 = 989e12  # H100 SXM, dense bfloat16 (NVIDIA data sheet, at 700 W)
MFU_UNIT = "fraction_of_h100_bf16_dense_peak"
MFU_LIMIT = 1.05
SCORE_QUANTILES = (0.99, 0.995, 0.998, 0.999, 0.9995)


def build_page(seed: int = 0, h: int = 2560, w: int = 1920):
    rng = np.random.default_rng(seed)
    page = np.full((h, w, 3), 235, np.uint8)
    for r in range(14):
        for c in range(8):
            y, x = 80 + r * 170, 60 + c * 230
            page[y : y + 60, x : x + 180] = int(rng.integers(20, 80))
    return page


def build_crops(n: int = 32, h: int = 64, w: int = 256):
    rng = np.random.default_rng(7)
    crops = []
    for _ in range(n):
        c = np.full((h, w, 3), 250, np.uint8)
        c[20:44, 10 : 10 + int(rng.integers(120, 220))] = int(rng.integers(20, 90))
        crops.append(c)
    return crops


def is_smoke() -> bool:
    return os.environ.get("MANUSCRIPT_TPU_BENCH_SMOKE") == "1"


def card_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them; "cpu" for
    a smoke run."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[dev.index or 0]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, n_iters: int = 12, warmup: int = 1):
    """Median and raw per-iteration wall times."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n_iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


class Emitter:
    """Prints one JSON line per metric, each with the device's name; values
    keep 6 significant digits (a small MFU would round to 0 at the JAX
    bench's 4 decimals)."""

    def __init__(self, device: str, smoke: bool):
        self.device, self.smoke = device, smoke

    def __call__(self, metric, value, unit, vs_baseline=None, **extra):
        value = float(value)
        if not np.isfinite(value):
            raise RuntimeError(f"bench: {metric} is not finite: {value}")
        line = {"metric": metric, "value": float(f"{value:.6g}"), "unit": unit}
        if vs_baseline is not None:
            line["vs_baseline"] = round(vs_baseline, 3)
        line.update(extra)
        line["device"] = self.device
        if self.smoke:
            line["smoke"] = True
        print(json.dumps(line), flush=True)
        return line


def mfu(flops: float, per_sec: float, what: str) -> float:
    share = flops * per_sec / PEAK_FLOPS_BF16
    if not 0.0 < share <= MFU_LIMIT:
        raise RuntimeError(f"bench: {what} MFU {share:.4f} is outside (0, {MFU_LIMIT}]")
    return share


def word_sized_geometry(east) -> None:
    """Random weights give sub-pixel geometry: the geometry head's bias
    becomes a 24×8 map-pixel quad, so decoded boxes are word-sized."""
    with torch.no_grad():
        east.model.geo_head.bias.copy_(torch.tensor([-12.0, -4, 12, -4, 12, 4, -12, 4]))


def score_quantiles(east, page) -> tuple:
    """Calibration thresholds: the upper quantiles of ``page``'s score map."""
    from .ops.image import detector_preprocess_host

    x = torch.from_numpy(detector_preprocess_host(page, east.target_size)).to(east.device)
    with torch.inference_mode():
        score, _ = east.maps(x[None])
    q = torch.quantile(score.flatten().float().cpu(), torch.tensor(SCORE_QUANTILES))
    return tuple(sorted({round(float(v), 6) for v in q}))


def models(smoke: bool):
    """Device, random-weight EAST and TRBA (the geometry made word-sized)
    and the 6 bench pages."""
    from .detectors import EAST
    from .recognizers import TRBA
    from .utils.device import resolve_device

    # random weights by design: no checkpoint is fetched (the JAX bench sets
    # the same two variables)
    os.environ.setdefault("MANUSCRIPT_TPU_NO_DOWNLOAD", "1")
    os.environ.setdefault("MANUSCRIPT_TPU_ALLOW_RANDOM_INIT", "1")
    dev = torch.device("cpu") if smoke else resolve_device(None)
    # smoke pins 16 word slots, so it sets the box capacity that an auto
    # capacity of 16 would (4 × 16, at least 256)
    east = EAST(
        device=dev, target_size=128 if smoke else 1280, max_candidates=256 if smoke else 4096,
        max_boxes=256 if smoke else 1024, dtype=torch.bfloat16,
        backbone="resnet50-tiny" if smoke else "resnet50", allow_random_init=True, seed=0,
    )
    tiny = dict(cnn_stage_plan="micro", hidden_size=64, img_h=32, img_w=128, max_length=8)
    trba = TRBA(device=dev, dtype=torch.bfloat16, allow_random_init=True, seed=1,
                **(tiny if smoke else {}))
    word_sized_geometry(east)
    pages = [build_page(i, h=256, w=192) if smoke else build_page(i) for i in range(6)]
    return dev, east, trba, pages


def calibrate(fused, page):
    """``FusedOCR.calibrate`` among ``page``'s score-map quantiles, for at
    most 250 words → (threshold, {threshold: count})."""
    return fused.calibrate(page, score_quantiles(fused.detector, page), target_max_words=250)


def setup(smoke: bool):
    """``models`` and the calibrated default ``FusedOCR``."""
    from .fused import FusedOCR

    dev, east, trba, pages = models(smoke)
    fused = FusedOCR(east, trba, max_words=16 if smoke else "auto")
    thresh, counts = calibrate(fused, pages[0])
    return dev, east, trba, pages, fused, thresh, counts


def link_probe(fused, page, n: int = 4):
    """Seconds of one page's upload: the detector's uint8 copy from pinned
    host memory to the card, synchronised; median of ``n``."""
    size = fused.detector.target_size
    host = fused._host_pages([page], size)
    times = []
    for _ in range(n + 1):
        t0 = time.perf_counter()
        fused._upload(host)
        _sync(fused.device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times[1:]), times[1:]


def device_only_throughput(fused, pages, n_chunks: int = 6):
    """Pages/s of the device-crop program on one chunk prepared and uploaded
    once and held on the card: ``n_chunks`` chunks launched back to back,
    one synchronise at the end. The port has no single compiled program, so
    this includes the host's eager launches."""
    b = fused.batch_pages
    _, host, _, sx, sy, _ = fused._prepare_chunk(pages[:b])
    dev = fused.device
    stack = fused._upload(host)
    sx, sy = torch.from_numpy(sx).to(dev), torch.from_numpy(sy).to(dev)
    with torch.inference_mode():
        fused._page_program(stack, None, sx, sy)  # warm
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            fused._page_program(stack, None, sx, sy)
        _sync(dev)
    dt = time.perf_counter() - t0
    return n_chunks * b / dt, dt


def flops_of(fn) -> float:
    """FLOPs of ``fn()`` (``utils.profiling.count_flops``)."""
    from .utils.profiling import count_flops

    with count_flops() as fc:
        fn()
    return fc.total


def crop_metrics(pages, host_words, trba, target: int, scale_mult: int):
    """PSNR and global SSIM of the recognizer input cropped from the
    detector's (k·target)² copy against the one cropped from the full page,
    over the host path's first 64 words; (None, None) without a word."""
    from .ops.image import crop_axis_aligned, resize_and_pad, resize_u8

    side = target * scale_mult
    small = resize_u8(pages[0], side, side)
    sx, sy = pages[0].shape[1] / side, pages[0].shape[0] / side
    psnrs, ssims = [], []
    for w in host_words[:64]:
        poly = np.asarray(w.polygon, np.int32)
        full = crop_axis_aligned(pages[0], poly)
        if full is None or full.size == 0:
            continue
        ref_crop = resize_and_pad(full, trba.img_h, trba.img_w)
        ds_poly = np.stack([poly[:, 0] / sx, poly[:, 1] / sy], axis=1).astype(np.int32)
        ds = crop_axis_aligned(small, ds_poly)
        if ds is None or ds.size == 0:
            continue
        # the device gather's aspect correction: canvas geometry from the
        # original crop, samples from the detector's copy
        ds = resize_u8(ds, full.shape[0], full.shape[1])
        a = ref_crop.astype(np.float64)
        b = resize_and_pad(ds, trba.img_h, trba.img_w).astype(np.float64)
        mse = np.mean((a - b) ** 2)
        psnrs.append(99.0 if mse == 0 else 10 * np.log10(255.0**2 / mse))
        mu_a, mu_b, va, vb = a.mean(), b.mean(), a.var(), b.var()
        cov = ((a - mu_a) * (b - mu_b)).mean()
        c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
        ssims.append(((2 * mu_a * mu_b + c1) * (2 * cov + c2))
                     / ((mu_a**2 + mu_b**2 + c1) * (va + vb + c2)))
    return (float(np.mean(psnrs)), float(np.mean(ssims))) if psnrs else (None, None)


def sustained_steps(run_step, dev, n: int = 10) -> float:
    run_step()  # warm
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        loss = run_step()
    float(loss)
    return n / (time.perf_counter() - t0)


def east_train_bench(dev, smoke: bool):
    """The JAX bench's EAST step: resnet50 at 1024², batch 8, bfloat16
    compute (autocast; float32 parameters and loss), ASAM + SGD with OHEM,
    focal geometry and EMA → (steps/s, FLOPs a step, config)."""
    from .models.east import EASTModel
    from .train import east_train
    from .train.optim import build_east_optimizer
    from .utils.weights import init_random_

    side, bsz = (64, 2) if smoke else (1024, 8)
    model = init_random_(EASTModel("resnet50-tiny" if smoke else "resnet50"), 0).to(dev)
    trainable = dict(model.named_parameters())
    tx, _ = build_east_optimizer(1e-3, steps_per_epoch=10, use_sam=True)
    ema = {k: p.detach().clone() for k, p in trainable.items()}
    state = east_train.EASTTrainState(model, tx.init(trainable), ema)
    img = torch.zeros((bsz, side, side, 3), dtype=torch.uint8, device=dev)
    score = torch.ones((bsz, side // 4, side // 4), device=dev)
    geo = torch.zeros((bsz, side // 4, side // 4, 8), device=dev)

    def step():
        with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=not smoke):
            return east_train.train_step(state, tx, trainable, img, score, geo, use_sam=True,
                                         sam_adaptive=True, use_ohem=True, ohem_ratio=0.5,
                                         use_focal_geo=True, focal_gamma=2.0)

    sps = sustained_steps(step, dev, n=3 if smoke else 10)
    config = (f"{side}^2 batch {bsz} {'f32' if smoke else 'bf16'}, ASAM+OHEM+focal+EMA "
              "(the JAX bench's reference-scale step)")
    return sps, flops_of(step), config


def trba_train_bench(dev, smoke: bool):
    """The JAX bench's TRBA step: hidden 256, 194 classes, batch 128, 32×128
    crops, max_len 40 (+SOS), Adam, bfloat16 compute, teacher-forced CE →
    (steps/s, FLOPs a step, config)."""
    from .models.trba import TRBAModel
    from .train import optim, trba_train
    from .utils.weights import init_random_

    t_b, t_len = (4, 9) if smoke else (128, 41)
    classes, hidden = (20, 32) if smoke else (194, 256)
    model = init_random_(TRBAModel(classes, hidden, 1, 2, None, "micro" if smoke else "full"), 0)
    model.to(dev)
    params = dict(model.named_parameters())
    tx = optim.adam(1e-3)
    state = {"o": tx.init(params)}
    batch = {"image": torch.zeros((t_b, 32, 128, 3), dtype=torch.uint8, device=dev),
             "text_in": torch.ones((t_b, t_len), dtype=torch.int64, device=dev),
             "target_y": torch.ones((t_b, t_len), dtype=torch.int64, device=dev)}

    def step():
        loss, state["o"] = trba_train.train_step(
            model, tx, state["o"], params, batch, pad_id=0,
            compute_dtype="float32" if smoke else "bfloat16",
        )
        return loss

    sps = sustained_steps(step, dev, n=3 if smoke else 10)
    config = (f"32x128 batch {t_b} hidden {hidden} classes {classes} len {t_len} "
              f"{'f32' if smoke else 'bf16'}, CE teacher-forced (the JAX bench's reference scale)")
    return sps, flops_of(step), config


def closed_loop(pipe, body: bytes, batch_pages: int, n_clients: int, seconds: float,
                batch_wait_ms: float = 10.0):
    """``n_clients`` closed-loop clients POSTing ``body`` to an in-process
    ``OCRServer`` over ``pipe`` for ``seconds`` → (latencies of the answered
    requests, the failed ones' errors, elapsed seconds, mean batch fill from
    ``/metrics``)."""
    from .serve import OCRServer

    srv = OCRServer(pipe, host="127.0.0.1", port=0, batch_pages=batch_pages,
                    batch_wait_ms=batch_wait_ms)
    srv.start_background()
    try:
        url = f"http://127.0.0.1:{srv.port}/ocr"
        stop_at = time.perf_counter() + seconds
        lat, failed, lock = [], [], threading.Lock()

        def client():
            while time.perf_counter() < stop_at:
                t0 = time.perf_counter()
                try:
                    req = urllib.request.Request(url, data=body, method="POST")
                    with urllib.request.urlopen(req, timeout=120) as resp:
                        error = None if resp.status == 200 and resp.read() else resp.status
                except (urllib.error.URLError, OSError) as exc:
                    error = repr(exc)
                seconds_taken = time.perf_counter() - t0
                with lock:
                    if error is None:
                        lat.append(seconds_taken)
                    else:
                        failed.append(error)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client) for _ in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=seconds + 300)
        elapsed = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise RuntimeError("bench: serving clients still running")
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics", timeout=10) as resp:
            text = resp.read().decode()
    finally:
        srv.shutdown()
    fill = next(float(ln.split()[-1]) for ln in text.splitlines()
                if ln.startswith("ocr_mean_batch_fill "))
    return lat, failed, elapsed, fill


def npy_body(page) -> bytes:
    buf = io.BytesIO()
    np.save(buf, page)
    return buf.getvalue()


def main():
    from .fused import FusedOCR
    from .pipeline import Pipeline
    from .utils.compile_cache import enable_compile_cache
    from .utils.metrics import compute_f1

    enable_compile_cache(None)
    smoke = is_smoke()
    raw = {"note": "all vs_baseline values divide by the reference's only recorded number: "
                   "EAST-only Colab mean 0.604 s/page"}
    dev, east, trba, pages, fused, thresh, counts = setup(smoke)
    emit = Emitter(card_name(dev), smoke)
    raw["device"] = emit.device
    n_pages = 4 if smoke else 24
    raw["calibrated_thresh"] = thresh
    raw["threshold_counts"] = {str(k): v for k, v in counts.items()}
    raw["word_capacity"] = fused.max_words
    raw["box_capacity"] = east.max_boxes
    raw["channel_folded"] = False  # the port uploads the plain uint8 page

    probe0, raw["link_probe_start_s"] = link_probe(fused, pages[0])
    page0 = fused.predict(pages[0])  # warm: cuDNN plans, the allocator
    if not smoke and fused.last_dropped:
        raise RuntimeError(f"bench: auto capacity {fused.max_words} dropped "
                           f"{fused.last_dropped} words")

    # ---- primary: the Pipeline default, median of 3 runs of 24 pages
    chunk = pages[: fused.batch_pages]
    run_pages = [pages[i % len(pages)] for i in range(n_pages)]
    fused.predict_many(chunk)
    dt, raw["fused_batch_s"] = timed(lambda: fused.predict_many(run_pages), 3, warmup=0)
    pages_per_sec = n_pages / dt
    primary = emit("e2e_pipeline_pages_per_sec", pages_per_sec, "pages/s",
                   vs_baseline=pages_per_sec / REFERENCE_PAGES_PER_SEC,
                   config="beam8_T1.7_a0.9_auto_capacity_native_crops (the Pipeline default)",
                   link_probe_s=round(probe0, 6))

    # ---- device-only: inputs held on the card, one synchronise
    dev_pps, raw["device_only_chain_s"] = device_only_throughput(fused, run_pages,
                                                                2 if smoke else 6)
    emit("fused_device_only_pages_per_sec", dev_pps, "pages/s",
         vs_baseline=dev_pps / REFERENCE_PAGES_PER_SEC,
         config="beam default, device crops, inputs held on the card, one synchronise "
                "(host launches included)")

    # ---- greedy and device-crop secondaries
    fused_g = FusedOCR(east, trba, max_words=fused.max_words, mode="greedy",
                       batch_pages=fused.batch_pages)
    fused_g.predict_many(chunk)
    g_dt, raw["fused_greedy_batch_s"] = timed(lambda: fused_g.predict_many(run_pages), 3, warmup=0)
    emit("e2e_greedy_pages_per_sec", n_pages / g_dt, "pages/s",
         vs_baseline=(n_pages / g_dt) / REFERENCE_PAGES_PER_SEC, config="greedy, native crops")
    fused_d = FusedOCR(east, trba, max_words=fused.max_words, mode="beam",
                       batch_pages=fused.batch_pages, crop_source="device")
    fused_d.predict_many(chunk)
    d_dt, raw["fused_devicecrop_batch_s"] = timed(lambda: fused_d.predict_many(run_pages), 3,
                                                  warmup=0)
    emit("e2e_devicecrop_pages_per_sec", n_pages / d_dt, "pages/s",
         vs_baseline=(n_pages / d_dt) / REFERENCE_PAGES_PER_SEC,
         config="one-program path, detector-resolution crops, beam default")

    n_iters = 3 if smoke else 5
    lat_med, raw["fused_single_page_s"] = timed(lambda: fused.predict(pages[0]), n_iters=n_iters)
    emit("fused_single_page_latency_s", lat_med, "s/page",
         vs_baseline=(1.0 / lat_med) / REFERENCE_PAGES_PER_SEC,
         config="single-page loop like the reference's Colab protocol, detect + recognize")

    # ---- MFU of the page program
    flops = flops_of(lambda: fused.predict(pages[0]))
    raw["flops_per_page"] = flops
    emit("fused_program_mfu", mfu(flops, dev_pps, "fused program"), MFU_UNIT,
         flops_per_page=flops, throughput="device_only")
    emit("fused_e2e_mfu", mfu(flops, pages_per_sec, "fused e2e"), MFU_UNIT,
         flops_per_page=flops, throughput="e2e")

    # ---- TRBA and EAST alone
    crops = build_crops(32)
    med2, raw["trba_b32_greedy_s"] = timed(
        lambda: trba.predict(crops, batch_size=32, mode="greedy"), n_iters=n_iters)
    emit("trba_greedy_crops_per_sec", 32.0 / med2, "crops/s")
    med3, raw["east_standalone_s"] = timed(lambda: east.predict(pages[0]), n_iters=n_iters)
    emit("east_standalone_pages_per_sec", 1.0 / med3, "pages/s",
         vs_baseline=(1.0 / med3) / REFERENCE_PAGES_PER_SEC)

    # ---- the fused device path's boxes against the host path's
    host_words = [w for b in east.predict(pages[0])["page"].blocks for w in b.words]
    fused_words = [w for b in page0.blocks for w in b.words]
    f1 = compute_f1([{"image_id": 0, "segmentation": np.asarray(w.polygon).ravel()}
                     for w in fused_words], 0.5,
                    {0: [np.asarray(w.polygon).ravel() for w in host_words]}, [0])
    raw["fused_vs_host_box_f1"] = f1
    emit("fused_vs_host_box_f1", f1, "f1@iou0.5", n_fused=len(fused_words), n_host=len(host_words))

    # ---- crops from the detector's copy against full-resolution crops
    psnr1, ssim1 = crop_metrics(pages, host_words, trba, east.target_size, 1)
    psnr2, ssim2 = crop_metrics(pages, host_words, trba, east.target_size, 2)
    raw["crop_psnr"] = {"scale1": psnr1, "scale2": psnr2, "ssim1": ssim1, "ssim2": ssim2}
    if psnr1 is None:
        raise RuntimeError("bench: the host path found no word to crop")
    emit("fused_crop_psnr_db", psnr1, "dB_vs_fullres_crops", ssim=round(ssim1, 4), crop_scale=1)
    emit("fused_crop_scale2_psnr_db", psnr2, "dB_vs_fullres_crops", ssim=round(ssim2, 4),
         crop_scale=2)

    # ---- quality: the committed micro checkpoints on 8 held-out pages, as
    # chip_smoke.py phase 7 runs them (TF32 off)
    if smoke:
        raw["quality_skipped"] = "smoke mode"
    else:
        from .utils.quality import evaluate_quality, load_quality_models

        tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            qmodels = load_quality_models(dev)
            q = {name: evaluate_quality(n_pages=8, seed=9000, mode="beam", models=qmodels, **kw)
                 for name, kw in (("native", {}), ("device", {"crop_source": "device"}),
                                  ("crop_scale_2", {"crop_scale": 2}),
                                  ("classic", {"use_fused": False}))}
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        raw["quality"] = q
        emit("detector_f1", q["native"]["detector_f1"], "f1@iou0.5",
             n_gt_words=q["native"]["n_gt_words"])
        emit("e2e_synthetic_cer", q["native"]["e2e_cer"], "cer",
             word_acc=round(q["native"]["word_acc"], 4),
             matched_cer=round(q["native"]["matched_cer"], 4),
             config="fused beam, native crops (the default), micro ckpts")
        emit("e2e_synthetic_cer_devicecrop", q["device"]["e2e_cer"], "cer",
             word_acc=round(q["device"]["word_acc"], 4),
             config="one-program path, detector-resolution crops")
        emit("e2e_synthetic_cer_crop_scale2", q["crop_scale_2"]["e2e_cer"], "cer",
             word_acc=round(q["crop_scale_2"]["word_acc"], 4))
        emit("e2e_synthetic_cer_hostcrops", q["classic"]["e2e_cer"], "cer",
             word_acc=round(q["classic"]["word_acc"], 4),
             config="classic path, full-resolution host crops")

    # ---- 100 pages
    n100 = 8 if smoke else 100
    batch100 = [pages[i % len(pages)] for i in range(n100)]
    t0 = time.perf_counter()
    fused.predict_many(batch100)
    raw["fused_100page_s"] = dt100 = time.perf_counter() - t0
    emit("batched_100page_pages_per_sec", n100 / dt100, "pages/s",
         vs_baseline=(n100 / dt100) / REFERENCE_PAGES_PER_SEC, config="beam default")

    # ---- training steps at the reference's scale
    e_sps, e_flops, e_config = east_train_bench(dev, smoke)
    emit("east_sam_train_steps_per_sec", e_sps, "steps/s", config=e_config)
    emit("east_train_step_mfu", mfu(e_flops, e_sps, "EAST train step"), MFU_UNIT,
         flops_per_step=e_flops)
    t_sps, t_flops, t_config = trba_train_bench(dev, smoke)
    emit("trba_train_steps_per_sec", t_sps, "steps/s", config=t_config)
    emit("trba_train_step_mfu", mfu(t_flops, t_sps, "TRBA train step"), MFU_UNIT,
         flops_per_step=t_flops)
    raw["train_flops_per_step"] = {"east": e_flops, "trba": t_flops}

    # ---- serving: the HTTP stack, closed-loop clients, .npy bodies
    spipe = Pipeline(detector=east, recognizer=trba, device=dev, mode="beam",
                     max_words=fused.max_words, batch_pages=fused.batch_pages)
    spipe.predict(pages[0])
    spipe.process_batch(pages[: fused.batch_pages])
    n_clients = 3 if smoke else 12
    lat, failed, sv_elapsed, fill = closed_loop(spipe, npy_body(pages[0]), fused.batch_pages,
                                                n_clients, 3.0 if smoke else 12.0)
    raw["serve"] = {"n_ok": len(lat), "failed": failed, "elapsed_s": sv_elapsed,
                    "mean_batch_fill": fill}
    if failed or not lat:
        raise RuntimeError(f"bench: {len(failed)} of {len(lat) + len(failed)} requests failed: "
                           f"{failed[:3]}")
    ls = sorted(lat)
    emit("serve_pages_per_sec", len(ls) / sv_elapsed, "pages/s",
         vs_baseline=(len(ls) / sv_elapsed) / REFERENCE_PAGES_PER_SEC, clients=n_clients,
         errors=0, mean_batch_fill=round(fill, 3),
         config="HTTP npy bodies, pipelined batcher, beam default")
    emit("serve_latency_p50_s", statistics.median(ls), "s", n=len(ls))
    emit("serve_latency_p99_s", ls[int(0.99 * (len(ls) - 1))], "s", n=len(ls))

    # ---- the primary again, last
    probe1, raw["link_probe_end_s"] = link_probe(fused, pages[0])
    last_dt, raw["fused_batch_last_s"] = timed(lambda: fused.predict_many(run_pages), 3, warmup=0)
    emit("e2e_pipeline_pages_per_sec_last", n_pages / last_dt, "pages/s",
         vs_baseline=(n_pages / last_dt) / REFERENCE_PAGES_PER_SEC,
         link_probe_s=round(probe1, 6), config="same as the primary, measured last")

    RAW_PATH.parent.mkdir(parents=True, exist_ok=True)
    RAW_PATH.write_text(json.dumps(raw, indent=1))
    return primary


def perf_gate():
    """The two numbers of the card's regression gate, device-only pages/s and
    the program's MFU, as one ``PERF_GATE {...}`` line
    (``tests/test_torch_cuda.py`` holds them to floors)."""
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache(None)
    smoke = is_smoke()
    dev, east, trba, pages, fused, thresh, _ = setup(smoke)
    fused.predict(pages[0])  # warm
    pps, _ = device_only_throughput(fused, pages)
    flops = flops_of(lambda: fused.predict(pages[0]))
    out = {
        "device_only_pages_per_sec": round(pps, 3),
        "program_mfu": round(mfu(flops, pps, "fused program"), 6),
        "flops_per_page": flops,
        "word_capacity": fused.max_words,
        "backend": dev.type,
        "device": card_name(dev),
    }
    if smoke:
        out["smoke"] = True
    print("PERF_GATE " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    if "--perf-gate" in sys.argv:
        perf_gate()
    else:
        main()
