#!/usr/bin/env python3
"""Smoke run of manuscript_tpu_torch on one CUDA card.

    python3 chip_smoke.py

from the root of a checkout. Phases, each checking; a failed phase ends the
run with a traceback and a non-zero exit:

1. build the CUDA kernels of manuscript_tpu_torch/csrc with nvcc and the
   host LANMS (csrc/lanms.cpp) with the host C++ compiler, all at once (into
   build/kernels/), and print each source's seconds;
2. hold each kernel against its plain torch version at the main paths'
   shapes, and time both (CUDA events over a CUDA graph of repeated calls,
   median of several replays, after warm-up): K1 at R = 256..4096 beam rows
   (beam 8; 8·nw for one page, 8·B·nw for a chunk of B pages), K2's gathered
   entry at the NMS's sizes for one page and for a chunk of 4 pages (per-page
   live counts) beside the same call made of torch gathers and the pairs
   kernel, and the matrix entry at 1024×1024; K3 (the scan LANMS's merge
   walk) at 2048 and 8192 candidates, max_out 1024, against its plain loop
   (timed once with CUDA events): equal counts, quads within 1e-3 px;
3. full width with random weights from a seed: EAST resnet50 at 1280² (q=2,
   8192 candidates, 1024 boxes, bf16) and TRBA full (64×256, hidden 256,
   194 tokens, beam 8, max_len 25); first the recognizer's first and second
   pass at new batch shapes (what ``FusedOCR.warm_next_bucket`` is for);
   then ``Pipeline.predict`` on 3 pages,
   with the kernels' launch counts read around exactly that run (25 K1
   steps per page, K2 in both NMS calls) and each page's word slots; then
   the recognizer on a fixed 32-crop strip (256 beam rows);
4. the committed micro checkpoints (manuscript_tpu/configs/quality/) on one
   synthetic page, on the card and on the CPU: equal texts, boxes within
   1e-2 px;
5. phase 3's configuration on 8 pages through ``Pipeline.process_batch``
   (4 pages a chunk) and through a loop of ``predict``: pages/s of both,
   host-clock seconds per stage per chunk, each chunk's slots, the launch
   counts around exactly the ``process_batch`` call (25 K1 steps and at
   least 2 K2 launches per chunk); one chunk's batched phase A and phase B
   against the same inputs page by page (equal valid rows, boxes within
   1e-2 px; equal texts with TF32 off, but for beam ties); the same 8 pages with device crops
   and with ``crop_scale=2`` at 128 slots a page (pages/s, peak memory,
   launch counts, finite boxes and confidences); and ``process_batch`` on
   16 pages with one CUDA stream (the port) against phase B on a second
   stream, with the card's idle share from a torch.profiler trace of each;
6. the micro checkpoints with TF32 off: ``process_batch`` on 5 held-out
   pages equals a loop of ``predict`` on the card for native and device
   crops (equal texts, boxes within 1e-2 px), and ``calibrate`` gives the
   same threshold and counts on the card as on the CPU;
7. ``evaluate_quality`` (8 held-out pages, seed 9000, beam) on the card with
   native crops, device crops, ``crop_scale=2`` and the classic path
   (``use_fused=False``) against the JAX package's CPU numbers in
   ``manuscript_tpu_torch/configs/quality_reference.json``: ``detector_f1``
   equal to 3 decimals, ``e2e_cer`` within 0.005;
8. the classic host path at phase 3's full width: ``EAST.predict`` with the
   host LANMS and with the scan LANMS on the card (K3) on 3 pages (equal box
   counts, sorted polygons within rtol 1e-2, atol 0.5) with each stage's
   seconds, ``predict_batch`` (4 a chunk) on 8 pages, ``TRBA.predict`` on
   64 crops in batches of 32 (2 × 25 K1 steps), ``Pipeline(fused=False)``
   ``predict`` on 3 pages and ``process_batch`` on 8 (pages/s beside phase
   5's, launch counts around each run); then on the micro checkpoints, TF32
   off, ``Pipeline(fused=False)`` texts equal on the card and the CPU;
9. serving: an in-process ``OCRServer`` over the micro pipeline answers 8
   concurrent ``.npy`` requests with ``Pipeline.predict``'s texts and counts
   8 pages in ``/metrics``; over phase 3's full-width pipeline, 32 requests
   from 8 client threads (pages/s, p50/p99 latency, mean batch fill); and
   ``python -m manuscript_tpu_torch serve`` as a subprocess (random
   weights, an empty HOME) answers ``/healthz`` with the card's name and
   one ``.npy`` POST with 200, and is stopped;
10. training: one TRBA step (dropout 0) and one EAST step (ASAM + SGD,
   OHEM, focal geometry) from the micro checkpoints on the card and on the
   CPU with TF32 off, each SGD at a scale of 1e6 (|d| of the loss, of the
   gradients read off the update, and of the running statistics);
   ``TRBA.train`` at full width (64×256, hidden 256, 194 tokens, batch 64,
   Adam, clip 5, dropout on) on 256 rendered crops written as PNG, 2 epochs
   with beam validation and a third resumed from ``last_state.msgpack``
   (median seconds of a ``train_step`` call, synchronised before and after,
   samples/s, peak memory,
   validation accuracy and CER, and the K1 steps around the validations:
   26 greedy + 25 beam a batch), ``best_acc.msgpack`` read by ``TRBA``, 30
   steps on one fixed batch (the loss falls) and an epoch in bfloat16;
   ``EAST.train`` at its defaults (resnet101, 1024², batch 3, ASAM + SGD,
   OHEM, focal, multiscale, freeze_first) on 6 synthetic pages with COCO
   labels, GPU-resident and streamed, and RAdam + Lookahead + EMA over 6
   steps (one Lookahead sync), with step seconds, peak memory, validation
   loss and soft dice, and ``best.msgpack`` read by ``EAST``;
11. reference weights, TPS, vis: seeded state dicts of the reference's
   layout (EAST-R50 with every key ``convert_east`` reads; TRBA full plan,
   hidden 256, 194 classes, every key of ``convert_trba``, and a
   ``config.json``) written with ``torch.save`` and served as ``file://``
   release URLs to ``EAST()`` and ``TRBA()`` with no path, an empty HOME and
   an empty cache: every leaf loaded and none skipped, a second construction
   reads the cache and fetches nothing, a pinned wrong sha256 is refused and
   leaves no file; then ``Pipeline.predict(vis=True)`` on 3 full-width pages
   with the converted models and phase 3's geometry bias and threshold (25
   K1 steps and at least 2 K2 launches a page, finite words, the image at
   the page's size, the page darkened by 0.3 far from every box and every
   reading-order line, the same boxes as without ``vis``; seconds a page
   with and without), ``process_batch(vis=True)`` on 8 pages, and the CLI's
   ``ocr --vis`` and ``detect --vis`` (at phase 3's threshold) as
   subprocesses (their PNG decodes to the page's size);
   ``TRBAModel(use_tps=True)`` at full width beam-decodes
   256 crops (beam 8, R = 2048) in 25 K1 steps, with the same tokens as the
   model without TPS (identity TPS, shared weights) but for near-ties, its
   encode seconds beside the plain model's and its peak memory (a row may
   read otherwise only as a near-tie, confidence within 1e-4), and a micro
   ``use_tps=True`` model on the card against the CPU; and
   ``create_collage`` on the card's maps of one page;
12. the measuring tools: ``utils.profiling.trace``/``annotate``/
   ``device_split`` over 3 full-width TRBA training steps (phase 10's
   configuration, batch 64: forward, backward, optimizer), 2 EAST ASAM
   steps at the trainer's defaults (first pass, second pass, update) and one
   ``process_batch`` of 4 full-width pages (phase A, phase B and its device
   launches), each with its top 10 kernels; ``python -m manuscript_tpu_torch
   bench`` at full size as a subprocess (every line finite and naming the
   card, the primary first, every MFU in (0, 1.05], the micro checkpoints'
   quality lines equal to ``configs/quality_reference.json`` within phase
   7's tolerances) and its ``--perf-gate``; the serving bench with ``.npy``
   and PNG bodies (8 clients, 10 s each, no failed request); a decode sweep
   (``utils.sweep.Study``, sqlite, 8 trials over mode, beam size, alpha and
   temperature) on the micro TRBA and 64 rendered crops, K1's steps counted
   around each trial, and ``sweep-report`` naming its best trial; and the
   kernel cache: one process builds every source into
   ``MANUSCRIPT_TPU_KERNEL_CACHE``, a second with no compiler on PATH
   builds nothing and loads them;
13. the mesh (``manuscript_tpu_torch.parallel``): the card count;
   ``make_mesh(n_devices=1)`` runs and ``make_mesh(n_devices=count + 1)``
   raises; phase 5's 8 pages through ``process_batch`` with two shards on the
   one card (``make_mesh(devices=["cuda:0"] * 2)``, 4 pages a chunk, 2 a
   shard) against no mesh at 2 pages a chunk, the capacity pinned at phase
   5's: pages/s of both, K1 25 steps and K2 at least 2 launches per shard
   and chunk, the same words, boxes within 1e-2 px, texts equal but for
   ties of equal score; the same pages through ``Pipeline(mesh=)`` under a
   process group of 2 gloo ranks on the card, each rank given every page and
   returning every page, equal to the other rank's and to no mesh; phase
   10's micro steps in float64 on batches whose halves differ in brightness,
   with 2 gloo ranks on the card and with a 1-rank NCCL group
   (``parallel.spawn``), each within 1e-8 (TRBA) or 1e-6 (EAST, float32
   heads) of each leaf's largest entry of the 1-rank step without a group,
   and the 2 ranks with per-rank BatchNorm statistics outside that bound;
   ``TRBA.train`` and ``EAST.train`` with ``mesh=`` 2 gloo ranks on the card
   (phase 10's shapes, one epoch) against the call without a mesh, step and
   validation losses within 1e-4 relative, and EAST streamed from the host
   with 1 rank and 2 (the host seconds per step); with two or more cards,
   ``process_batch`` over cards 0 and 1, the TRBA step with 2 NCCL ranks and
   the micro pages with 2 NCCL ranks (each rank returns every page) — on
   one card it prints that this part did not run.

The script sets ``MANUSCRIPT_TPU_NO_DOWNLOAD=1`` for itself and its
subprocesses (phase 11 lifts it while it fetches from ``file://``): a
constructor that finds no checkpoint would otherwise try the network.

It prints the card's name and power limit, one JSON line with a row per
kernel (K1 and K2 launches from phase 5, K3 launches from phase 8), and last
the line ``{"ok": true, "device": {...}}``. Without a CUDA card, or without
the rest of the repository beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
from pathlib import Path

import numpy as np

# no constructor here fetches the reference's release over the network
os.environ["MANUSCRIPT_TPU_NO_DOWNLOAD"] = "1"

ROOT = Path(__file__).resolve().parent
START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores


def check(ok, what) -> None:
    """A phase's assertion (kept under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase(name: str) -> None:
    print(f"\n=== {name} === ({time.perf_counter() - START:.1f} s since the start)", flush=True)


def graph_time_ms(torch, fn, calls: int = 20, replays: int = 7) -> float:
    """Device time of one ``fn()``: a CUDA graph of ``calls`` back-to-back
    calls, replayed after warm-up, timed with CUDA events; median per call."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_profile(torch, fn, calls: int = 1) -> dict:
    """Kernels and copies that ``fn()`` puts on the card, from a torch.profiler
    trace of ``calls`` calls: {name: (operations per call, device ms per
    call)}; empty when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0]: (e.count / calls, e.device_time_total / calls / 1e3)
            for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}


def device_ops(torch, fn) -> int:
    """Kernels and copies that one ``fn()`` puts on the card."""
    return round(sum(n for n, _ in device_profile(torch, fn).values()))


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def test_quads(rng, n: int) -> tuple:
    """Pairs of quads: jittered and rotated boxes, near-duplicates,
    identical, edge-touching and disjoint pairs."""
    def boxes(m):
        w, h = rng.uniform(20, 120, m), rng.uniform(8, 40, m)
        cx, cy = rng.uniform(0, 400, m), rng.uniform(0, 400, m)
        th = rng.uniform(-0.3, 0.3, m)
        local = np.stack([[-w, -h], [w, -h], [w, h], [-w, h]], 0).transpose(2, 0, 1) / 2
        rot = np.stack([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]).transpose(2, 0, 1)
        return (local @ rot.transpose(0, 2, 1) + np.stack([cx, cy], 1)[:, None]).astype(np.float32)

    q1, q2 = boxes(n), boxes(n)
    k = n // 5
    q2[:k] = q1[:k] + rng.normal(0, 0.5, (k, 4, 2)).astype(np.float32)  # near-duplicates
    q2[k : 2 * k] = q1[k : 2 * k]  # identical
    q2[2 * k : 3 * k] = q1[2 * k : 3 * k] + np.float32(1000.0)  # disjoint
    shift = q1[3 * k : 4 * k, 1] - q1[3 * k : 4 * k, 0]  # touching along an edge
    q2[3 * k : 4 * k] = q1[3 * k : 4 * k] + shift[:, None]
    return q1, q2


def synthetic_page(rng, h: int = 1200, w: int = 1600, n_words: int = 60) -> np.ndarray:
    """White page with dark word-like rectangles in rows."""
    page = np.full((h, w, 3), 250, np.uint8)
    for i in range(n_words):
        row, col = divmod(i, 6)
        y = 60 + row * 110 + int(rng.integers(-10, 10))
        x = 40 + col * 255 + int(rng.integers(0, 40))
        ww, hh = int(rng.integers(80, 200)), int(rng.integers(28, 48))
        page[y : y + hh, x : x + ww] = rng.integers(0, 80, (hh, ww, 1), dtype=np.uint8)
    return page


def device_trace(torch, fn) -> dict:
    """One ``fn()`` under torch.profiler. From the trace's kernels and copies:
    the card's busy seconds (all streams merged), its idle share of the
    call's host-clock seconds, and the seconds in which two streams ran at
    once; empty when the trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = ROOT / "build" / "trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    spans = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            stream = e.get("args", {}).get("stream", e.get("tid"))
            spans.setdefault(stream, []).append((e["ts"], e["ts"] + e["dur"]))
    path.unlink()
    if not spans:
        return {}

    def union_us(iv):
        busy, (start, end) = 0.0, sorted(iv)[0]
        for a, b in sorted(iv)[1:]:
            if a > end:
                busy, start, end = busy + end - start, a, b
            else:
                end = max(end, b)
        return busy + end - start

    busy = union_us([iv for ivs in spans.values() for iv in ivs]) / 1e6
    both = sum(union_us(ivs) for ivs in spans.values()) / 1e6 - busy
    return {"wall": wall, "busy": busy, "idle": 1.0 - busy / wall, "streams": len(spans),
            "two_at_once": both}


def full_width_models(torch):
    """Phase 3's detector and recognizer at full width, random weights from
    seeds 0 and 1 (phase 13's ranks load phase 3's state into them)."""
    from manuscript_tpu_torch import EAST, TRBA

    det = EAST(backbone="resnet50", target_size=1280, quantization=2,
               max_candidates=8192, max_boxes=1024, dtype=torch.bfloat16,
               allow_random_init=True, seed=0)
    rec = TRBA(cnn_stage_plan="full", img_h=64, img_w=256, hidden_size=256,
               max_length=25, allow_random_init=True, seed=1)
    return det, rec


def word_sized_boxes(torch, det, page) -> None:
    """Random weights give sub-pixel geometry and scores near 0.4: set the
    geometry bias to a word-sized quad (24×8 map px) and the threshold to the
    99.5th percentile of ``page``'s score map, so that phase A emits word
    boxes and phase B recognizes them."""
    from manuscript_tpu_torch.ops.image import detector_preprocess_host

    with torch.no_grad():
        det.model.geo_head.bias.copy_(torch.tensor([-12.0, -4, 12, -4, 12, 4, -12, 4]))
        x = torch.from_numpy(detector_preprocess_host(page, det.target_size)).to(det.device)
        score = det.model(((x.to(det.dtype) / 255.0 - 0.5) / 0.5)[None])["score"]
        det.score_thresh = float(torch.quantile(score.flatten().float(), 0.995))


def words_of(page) -> list:
    return [w for blk in page.blocks for w in blk.words]


def check_finite(words) -> None:
    for w_ in words:
        check(np.all(np.isfinite(w_.polygon)) and np.isfinite(w_.detection_confidence), w_)
        check(w_.recognition_confidence is None or np.isfinite(w_.recognition_confidence), w_)


def many_pages(torch, det, rec, rng, k1, k2):
    """Phase 5: 8 full-width pages through ``process_batch`` (4 a chunk) and
    through a loop of ``predict``, with the launch counts around exactly the
    ``process_batch`` call; then the exact checks of one chunk's batched
    phases, the device-crop paths, and one CUDA stream against two."""
    from manuscript_tpu_torch import Pipeline
    from manuscript_tpu_torch.ops.image import detector_preprocess_host

    pipe = Pipeline(det, rec, beam_size=8, batch_pages=4)
    pages = [synthetic_page(rng) for _ in range(8)]
    pipe.process_batch(pages[:4])  # warm-up: cuDNN plans at 4 pages, capacity
    pipe.predict(pages[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k1.kernel_launches = k2.launches = 0
    t0 = time.perf_counter()
    batch = pipe.process_batch(pages)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    launches = {"attention_step": k1.launches, "quad_iou": k2.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    chunks = [dict(c) for c in pipe._fused.chunk_timings]
    t0 = time.perf_counter()
    loop = [pipe.predict(p) for p in pages]
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    print(f"process_batch: {len(pages)} pages in {t_batch:.4f} s = {len(pages) / t_batch:.4f} "
          f"pages/s, peak memory allocated {peak:.3f} GiB; predict loop: {t_loop:.4f} s = "
          f"{len(pages) / t_loop:.4f} pages/s")
    print("stage seconds per chunk (host clock; detect and recognize are launches, crops "
          "and finish include the waits): "
          + str([{k: round(v, 4) if isinstance(v, float) else v for k, v in c.items()}
                 for c in chunks]))
    print(f"slots per chunk (nw): {[c['slots'] for c in chunks]}, so K1 ran at R = 8·B·nw = "
          f"{[8 * c['pages'] * c['slots'] for c in chunks]} beam rows; launches {launches} "
          f"({k1.kernel_launches} K1 kernel launches) on {len(chunks)} chunks")
    check(len(chunks) == 2 and all(c["pages"] == 4 for c in chunks), chunks)
    # one 25-step beam decode per chunk, both NMS calls of each chunk's phase A
    check(launches["attention_step"] == 25 * len(chunks), launches)
    check(launches["quad_iou"] >= 2 * len(chunks), launches)
    words = [words_of(p) for p in batch]
    ref = [words_of(p) for p in loop]
    for ws in words:
        check_finite(ws)
    same = sum(len(a) == len(b) and [w.text for w in a] == [w.text for w in b]
               for a, b in zip(words, ref))
    # each box's distance to the nearest box of the other page (reading
    # order may differ when boxes move)
    box_d = [round(float(np.abs(np.subtract(np.array([w.polygon for w in a])[:, None],
                                            np.array([w.polygon for w in b])[None]))
                         .max(axis=(2, 3)).min(axis=1).max()), 4)
             for a, b in zip(words, ref) if len(a) == len(b) and a]
    print(f"boxes per page {[len(ws) for ws in words]} (predict loop {[len(ws) for ws in ref]}); "
          f"pages with the same words and texts as the loop: {same} of {len(pages)}; max box "
          f"|d| px on the pages with equal counts {box_d}")
    # where the two differ: EAST's bf16 score maps for 4 pages at once
    # against one page at a time, and the cells that cross the threshold
    with torch.inference_mode():
        x = torch.from_numpy(np.stack([detector_preprocess_host(p, det.target_size)
                                       for p in pages[:4]])).to(det.device)
        x = (x.to(det.dtype) / 255.0 - 0.5) / 0.5
        s4 = det.model(x)["score"].float()
        s1 = torch.cat([det.model(x[i : i + 1])["score"].float() for i in range(4)])
    flips = int(((s4 > det.score_thresh) != (s1 > det.score_thresh)).sum())
    print(f"EAST score maps ({det.dtype}), 4 pages at once vs one at a time: max |d| "
          f"{(s4 - s1).abs().max().item():.3e}; cells on the other side of the threshold "
          f"{flips} of {s4.numel()}")
    chunk_equals_pages(torch, pipe._fused, pages[:4], k1, k2)
    device_crop_pages(torch, det, rec, pages, k1, k2)
    one_stream_or_two(torch, pipe, pages + [synthetic_page(rng) for _ in range(8)])
    return (launches, chunks, {"process_batch": len(pages) / t_batch, "predict loop": len(pages) / t_loop},
            pages, pipe._fused.max_words)


def chunk_equals_pages(torch, fused, pages, k1, k2) -> None:
    """One chunk at full width, batched against page by page on the same
    inputs: decode → NMS → postprocess on the chunk's EAST maps against each
    page's maps alone (the same valid rows, boxes within 1e-2 px), and phase
    B on the chunk's strip against each page's slots alone, TF32 off (the
    same texts but for ties of equal score, confidences within 1e-4)."""
    from manuscript_tpu_torch.fused import _Pending

    det, rec = fused.detector, fused.recognizer
    imgs, host, _, sx, sy, timings = fused._prepare_chunk(pages)
    b = len(pages)
    with torch.inference_mode():
        x = fused._upload(host)
        out = det.model((x.to(det.dtype) / 255.0 - 0.5) / 0.5)
        score, geo = out["score"][..., 0], out["geometry"]
        sx_d, sy_d = torch.from_numpy(sx).to(x.device), torch.from_numpy(sy).to(x.device)
        k2.launches = 0
        chunk = fused._boxes(score, geo, det.score_thresh, sx_d, sy_d)
        k2_chunk = k2.launches
        single = torch.cat([
            fused._boxes(score[i : i + 1], geo[i : i + 1], det.score_thresh,
                         sx_d[i : i + 1], sy_d[i : i + 1])
            for i in range(b)
        ])
    valid = chunk[..., 8] >= 0
    check(torch.equal(valid, single[..., 8] >= 0), "valid rows, chunk vs pages")
    box_d = (chunk - single)[valid].abs().max().item()
    bit_rows = int((chunk != single)[valid].any(-1).sum())
    print(f"phase A, one chunk of {b} pages vs page by page on the same EAST maps: valid rows "
          f"{valid.sum(1).tolist()} equal; max |d| {box_d:.3e} over boxes and scores, rows not "
          f"bit-equal {bit_rows} of {int(valid.sum())}; K2 launches for the chunk {k2_chunk}")
    check(box_d <= 1e-2, box_d)
    check(k2_chunk >= 2, k2_chunk)

    strip, nw = fused._crop_stage(imgs, _Pending(chunk), timings)[3:5]
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    args = (fused.mode, fused.beam_size, fused.alpha, fused.temperature)
    with torch.inference_mode():
        xs = fused._upload(strip).reshape(-1, rec.img_h, rec.img_w, 3)
        k1.launches = 0
        p_all, c_all = rec.recognize_tensor(xs, *args)
        k1_chunk = k1.launches
        per = [rec.recognize_tensor(xs[i * nw : (i + 1) * nw], *args) for i in range(b)]
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    p_one, c_one = torch.cat([p for p, _ in per]).cpu(), torch.cat([c for _, c in per])
    p_all = p_all.cpu()
    other = torch.nonzero((p_all != p_one).any(-1)).flatten().tolist()
    texts = [(rec.decode(p_all[i].tolist()), rec.decode(p_one[i].tolist())) for i in other]
    conf_d = (c_all - c_one).abs().max().item()
    print(f"phase B on the chunk's strip ({b} × {nw} slots, R = {8 * b * nw}) vs page by page, "
          f"TF32 off: slots with other token ids {len(other)} of {p_all.shape[0]} "
          f"{[(p_all[i].tolist(), p_one[i].tolist()) for i in other[:2]]}, their texts "
          f"(chunk, page) {texts}; max |d| of the confidences {conf_d:.3e}; K1 steps for the "
          f"chunk {k1_chunk}")
    check(k1_chunk == 25, k1_chunk)
    # float sums in another order (cuDNN and cuBLAS pick their kernels by
    # batch) may swap two beam hypotheses of equal score: a slot may read
    # otherwise only when both confidences agree within 1e-6, and on at most
    # 1 % of the slots; every other slot's text is equal
    swapped = [i for i, (a, b_) in zip(other, texts) if a != b_]
    check(len(swapped) <= p_all.shape[0] // 100, swapped)
    check(all(abs(c_all[i].item() - c_one[i].item()) <= 1e-6 for i in swapped), swapped)
    check(conf_d <= 1e-4, conf_d)


def device_crop_pages(torch, det, rec, pages, k1, k2) -> None:
    """The 8 full-width pages through ``process_batch`` with crops gathered
    on the card from the detector's copy and from a 2× copy, at 128 word
    slots a page (K1 at R = 4096 on those crops), with the launch counts
    around exactly each call."""
    from manuscript_tpu_torch import Pipeline

    for name, kw in (("crop_source=device", {"crop_source": "device"}),
                     ("crop_scale=2", {"crop_scale": 2})):
        pipe = Pipeline(det, rec, beam_size=8, batch_pages=4, max_words=128, **kw)
        pipe.process_batch(pages[:4])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1.launches = k1.kernel_launches = k2.launches = 0
        t0 = time.perf_counter()
        out = pipe.process_batch(pages)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {"attention_step": k1.launches, "quad_iou": k2.launches}
        peak = torch.cuda.max_memory_allocated() / 2**30
        chunks = pipe._fused.chunk_timings
        words = [words_of(p) for p in out]
        print(f"{name}: {len(pages)} pages in {dt:.4f} s = {len(pages) / dt:.4f} pages/s, peak "
              f"memory allocated {peak:.3f} GiB; launches {launches}; boxes per page "
              f"{[len(ws) for ws in words]}, recognized "
              f"{[sum(w.text is not None for w in ws) for ws in words]}; stage seconds per "
              "chunk " + str([{k: round(v, 4) if isinstance(v, float) else v
                               for k, v in c.items()} for c in chunks]))
        check(len(chunks) == 2 and all(c["pages"] == 4 and c["slots"] == 128 for c in chunks),
              chunks)
        check(launches["attention_step"] == 25 * len(chunks), launches)
        check(launches["quad_iou"] >= 2 * len(chunks), launches)
        check(all(len(ws) > 0 for ws in words), [len(ws) for ws in words])
        check(sum(w.text is not None for ws in words for w in ws) > 0, name)
        for ws in words:
            check_finite(ws)


def one_stream_or_two(torch, pipe, pages) -> None:
    """The port enqueues both phases on one CUDA stream. Against it, the same
    ``process_batch`` with each phase-B launch moved to a second stream here,
    so that chunk i+1's phase A (and its NMS syncs) need not wait behind
    chunk i's phase B: pages/s on 16 pages (4 chunks) in the order one, two,
    two, one, each chunk's phase-A launch seconds, and from one profiled call
    of each the card's idle share and the seconds two streams ran at once."""
    fused = pipe._fused
    side = torch.cuda.Stream()
    launch_b = fused._dispatch_rec_chunk

    def on_side(crop_res):
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            return launch_b(crop_res)

    def run(streams, profiled=False):
        if streams == 2:
            fused._dispatch_rec_chunk = on_side
        t0 = time.perf_counter()
        trace = device_trace(torch, lambda: pipe.process_batch(pages)) if profiled else None
        if not profiled:
            pipe.process_batch(pages)
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if streams == 2:
            del fused._dispatch_rec_chunk
        return dt, [round(c["detect"], 4) for c in fused.chunk_timings], trace

    rates = {1: [], 2: []}
    for streams in (1, 2, 2, 1):
        dt, detect, _ = run(streams)
        rates[streams].append(len(pages) / dt)
        print(f"{streams} stream(s): {len(pages)} pages {len(pages) / dt:.4f} pages/s; phase-A "
              f"launch seconds per chunk {detect}")
    for streams in (1, 2):
        _, _, tr = run(streams, profiled=True)
        if not tr:
            print(f"{streams} stream(s), profiled: not measured (no device activity in the trace)")
            continue
        print(f"{streams} stream(s), profiled: device idle share {tr['idle']:.4f} (busy "
              f"{tr['busy']:.4f} s of {tr['wall']:.4f} s, {tr['streams']} streams), seconds in "
              f"which two streams ran at once {tr['two_at_once']:.4f}")
    print(f"pages/s, mean of two: one stream {statistics.mean(rates[1]):.4f}, phase B on a "
          f"second stream {statistics.mean(rates[2]):.4f}")


def micro_batches(torch) -> None:
    """Phase 6: the micro checkpoints, TF32 off: ``process_batch`` on 5
    held-out pages equals a loop of ``predict`` on the card for both crop
    sources; ``calibrate`` gives the same threshold and counts on the card as
    on the CPU."""
    from manuscript_tpu_torch import Pipeline
    from manuscript_tpu_torch.fused import FusedOCR
    from manuscript_tpu_torch.utils.quality import load_quality_models
    from manuscript_tpu_torch.utils.synthetic import eval_pages

    pages = [p for p, _ in eval_pages(5, seed=9100)]
    for src in ("native", "device"):
        pipe = Pipeline(*load_quality_models("cuda"), max_words=32, crop_source=src)
        batch = [[w for blk in p.blocks for w in blk.words] for p in pipe.process_batch(pages)]
        chunks = [c["pages"] for c in pipe._fused.chunk_timings]
        loop = [[w for blk in pipe.predict(p).blocks for w in blk.words] for p in pages]
        check([len(ws) for ws in batch] == [len(ws) for ws in loop], (src, batch, loop))
        box_err = max(np.abs(np.subtract(a.polygon, b.polygon)).max()
                      for ws, wr in zip(batch, loop) for a, b in zip(ws, wr))
        texts = [[w.text for w in ws] for ws in batch]
        print(f"{src} crops: pages per chunk {chunks}, words per "
              f"page {[len(ws) for ws in batch]}, max box |d| process_batch vs predict "
              f"{box_err:.3e} px; first page's texts {texts[0]}")
        check(texts == [[w.text for w in ws] for ws in loop], (src, texts))
        check(box_err <= 1e-2, box_err)
    cal = {dev: FusedOCR(*load_quality_models(dev), max_words="auto").calibrate(pages[0])
           for dev in ("cuda", "cpu")}
    print(f"calibrate on the card: {cal['cuda']}; on the CPU: {cal['cpu']}")
    check(cal["cuda"] == cal["cpu"], cal)


def quality_on_card() -> None:
    """Phase 7: ``evaluate_quality`` (8 held-out pages, seed 9000, beam) with
    native crops, device crops, ``crop_scale=2`` and the classic path against
    the JAX package's CPU numbers in ``configs/quality_reference.json``."""
    from manuscript_tpu_torch.utils.quality import evaluate_quality

    ref = json.loads((ROOT / "manuscript_tpu_torch" / "configs" / "quality_reference.json").read_text())
    for name, kw in (("native", {}), ("device", {"crop_source": "device"}),
                     ("crop_scale_2", {"crop_scale": 2}), ("classic", {"use_fused": False})):
        t0 = time.perf_counter()
        got = evaluate_quality(**ref["args"], **kw, device="cuda")
        print(f"{name}: detector_f1 {got['detector_f1']:.5f} (JAX CPU "
              f"{ref[name]['detector_f1']:.5f}), e2e_cer {got['e2e_cer']:.5f} (JAX CPU "
              f"{ref[name]['e2e_cer']:.5f}), word_acc {got['word_acc']:.5f}; "
              f"{time.perf_counter() - t0:.2f} s")
        check(round(got["detector_f1"], 3) == round(ref[name]["detector_f1"], 3), (name, got))
        check(abs(got["e2e_cer"] - ref[name]["e2e_cer"]) <= 0.005, (name, got))


def candidate_field(rng, n: int, words: int, size: float = 1280.0) -> np.ndarray:
    """``n`` detector candidates (n, 9): jittered copies of ``words`` word
    boxes on a size² canvas with scores in [0.5, 1), in random order."""
    c = rng.uniform(0, size, (words, 2))
    wh = np.stack([rng.uniform(40, 160, words), rng.uniform(15, 40, words)], 1)
    base = np.concatenate([c - wh / 2, c + [1, -1] * wh / 2, c + wh / 2, c + [-1, 1] * wh / 2], 1)
    rows = base[rng.integers(0, words, n)] + rng.normal(0, 2.0, (n, 8))
    return np.concatenate([rows, rng.uniform(0.5, 1, (n, 1))], 1).astype(np.float32)


def k3_rows(torch, k3, rng, dev) -> dict:
    """Phase 2, K3: the scan LANMS's merge walk at 2048 and 8192 candidates
    (all live, 16 candidates a word), max_out 1024, against its plain loop.
    The bound counts one clip (860 f32 operations, as K2's) per live step."""
    rows_out = {}
    for n in (2048, 8192):
        cands = torch.from_numpy(candidate_field(rng, n, n // 16)).to(dev)[None]
        inf = torch.full_like(cands[..., 0], float("inf"))
        key = torch.where(cands[..., 8] >= 0, cands[..., 0], inf)
        rows = cands[:, torch.sort(key, dim=1, stable=True).indices[0]].contiguous()
        pk, sk, mk = k3.lanms_merge_scan_cuda(rows, 0.2, 1024)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        pp, sp, mp = k3.lanms_merge_scan_plain(rows, 0.2, 1024)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        check(torch.equal(mk, mp), (mk, mp))
        m = min(int(mk[0]), 1024)
        err = max((pk - pp)[0, :m].abs().max().item(), (sk - sp)[0, :m].abs().max().item())
        check(err <= 1e-3, err)
        ms = graph_time_ms(torch, lambda: k3.lanms_merge_scan_cuda(rows, 0.2, 1024), calls=5, replays=5)
        nbytes = rows.numel() * 4 + 1024 * 9 * 4 + 4
        rows_out[n] = (ms, plain_ms, *bound(nbytes, n * 860), err)
        print(f"K3 lanms_merge_scan K={n} live candidates ({n // 16} words), max_out 1024: "
              f"{int(mk[0])} merged quads; max|d| = {err:.3e}; "
              "ms {:.4f} plain_ms (one call, CUDA events) {:.4f} bound_ms {:.6f} ({})".format(
                  *rows_out[n][:4]))
    return rows_out


def first_pass_cost(torch, rec) -> None:
    """The recognizer's first pass at a batch shape against its second, at
    full width (beam 8): what ``FusedOCR.warm_next_bucket`` spends on a zero
    strip so that a grown capacity or a short chunk does not pay it on a
    request. One shape first absorbs the process's one-time start-up."""
    def one(rows):
        x = torch.full((rows, rec.img_h, rec.img_w, 3), 255, dtype=torch.uint8, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec.recognize_tensor(x, "beam", 8, 0.9, 1.7)[1].cpu()
        return time.perf_counter() - t0

    one(32), one(32)
    for rows in (64, 96, 128, 256):
        first, second, third = one(rows), one(rows), one(rows)
        print(f"phase B at a new shape, {rows} crops: first pass {first:.4f} s, second "
              f"{second:.4f} s, third {third:.4f} s (first / second {first / second:.3f})")


def classic_path(torch, det, rec, rng, k1, k2, k3, fused_rates) -> dict:
    """Phase 8: the classic host path at full width; returns K3's launches
    around the ``nms="device"`` run."""
    from manuscript_tpu_torch import Pipeline
    from manuscript_tpu_torch.ops.image import crop_axis_aligned

    det.max_boxes = 1024  # the fused pipelines of phases 3 and 5 shrank it
    pages = [synthetic_page(rng) for _ in range(8)]
    det.nms = "host"
    det.predict(pages[0])  # warm-up
    host, stages = [], []
    for p in pages[:3]:
        host.append(det.predict(p))
        stages.append({k: round(v, 4) for k, v in det.last_timings.items()})
    det.nms = "device"
    det.predict(pages[0])  # warm-up
    torch.cuda.synchronize()
    k1.launches = k2.launches = k3.launches = 0
    dev_res, dev_stages = [], []
    for p in pages[:3]:
        dev_res.append(det.predict(p))
        dev_stages.append({k: round(v, 4) for k, v in det.last_timings.items()})
    launches = {"lanms_merge_scan": k3.launches, "quad_iou": k2.launches, "attention_step": k1.launches}
    det.nms = "host"
    print(f"EAST.predict, host LANMS: stage seconds per page {stages}")
    print(f"EAST.predict, scan LANMS on the card: stage seconds per page {dev_stages}; launches "
          f"around the 3 pages {launches}")
    check(launches["lanms_merge_scan"] == 3 and launches["quad_iou"] >= 3, launches)
    counts = []
    for h, d in zip(host, dev_res):
        wh, wd = words_of(h["page"]), words_of(d["page"])
        counts.append((len(wh), len(wd)))
        check(len(wh) == len(wd) and len(wh) > 0, (len(wh), len(wd)))
        ph = np.sort(np.array([w.polygon for w in wh]).reshape(len(wh), -1), 0)
        pd = np.sort(np.array([w.polygon for w in wd]).reshape(len(wd), -1), 0)
        check(np.allclose(ph, pd, rtol=1e-2, atol=0.5), np.abs(ph - pd).max())
        check_finite(wh + wd)
    print(f"boxes per page, host vs device LANMS: {counts}")

    det.predict_batch(pages[:4], batch_size=4)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = det.predict_batch(pages, batch_size=4)
    dt = time.perf_counter() - t0
    print(f"EAST.predict_batch(batch_size=4): {len(pages)} pages in {dt:.4f} s = "
          f"{len(pages) / dt:.4f} pages/s; boxes per page {[len(words_of(r['page'])) for r in batch]}")
    check(len(batch) == len(pages) and all(len(words_of(r["page"])) > 0 for r in batch), "predict_batch")
    for r in batch:
        check_finite(words_of(r["page"]))

    crops = []
    for p, r in zip(pages, host):
        for w in words_of(r["page"]):
            region = crop_axis_aligned(p, np.asarray(w.polygon, dtype=np.int32))
            if region is not None and region.size > 0:
                crops.append(region)
    crops = (crops * 2)[:64]
    check(len(crops) == 64, len(crops))
    k1.launches = 0
    t0 = time.perf_counter()
    texts = rec.predict(crops, batch_size=32)
    dt = time.perf_counter() - t0
    print(f"TRBA.predict: 64 crops in batches of 32 in {dt:.4f} s; K1 steps {k1.launches}; "
          f"confidences {[round(t['confidence'], 4) for t in texts[:4]]}...")
    check(k1.launches == 2 * rec.max_length and len(texts) == 64, k1.launches)
    check(all(np.isfinite(t["confidence"]) for t in texts), "confidences")

    pipe = Pipeline(det, rec, fused=False, beam_size=8)
    pipe.predict(pages[0])  # warm-up
    torch.cuda.synchronize()
    rates = {}
    for name, run, n in (("predict", lambda: [pipe.predict(p) for p in pages[:3]], 3),
                         ("process_batch", lambda: pipe.process_batch(pages, detector_batch_size=4), 8)):
        k1.launches = k2.launches = k3.launches = 0
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        runs = {"attention_step": k1.launches, "quad_iou": k2.launches, "lanms_merge_scan": k3.launches}
        rates[name] = n / dt
        read = [sum(w.text is not None for w in words_of(p)) for p in out]
        # one recognizer call per page (predict) or for all pages (process_batch),
        # in batches of 32 crops, max_length K1 steps each
        calls = read if name == "predict" else [sum(read)]
        steps = rec.max_length * sum(-(-k // 32) for k in calls)
        words = [w for p in out for w in words_of(p)]
        print(f"Pipeline(fused=False).{name}: {n} pages in {dt:.4f} s = {n / dt:.4f} pages/s; "
              f"boxes {len(words)}, recognized {sum(read)}; launches {runs} (the host LANMS "
              f"launches nothing; expected K1 steps {steps})")
        check(sum(read) > 0 and runs["attention_step"] == steps and runs["quad_iou"] == 0, runs)
        check_finite(words)
    print(f"pages/s, classic path {({k: round(v, 4) for k, v in rates.items()})} against the fused "
          f"path of phase 5 {({k: round(v, 4) for k, v in fused_rates.items()})}")
    return launches


def classic_micro(torch) -> None:
    """Phase 8, the micro checkpoints with TF32 off: ``Pipeline(fused=False)``
    gives the same texts on the card as on the CPU (host LANMS), and the scan
    LANMS gives the same boxes on the card as on the CPU."""
    from manuscript_tpu_torch import Pipeline
    from manuscript_tpu_torch.utils.quality import load_quality_models
    from manuscript_tpu_torch.utils.synthetic import eval_pages

    pages = [p for p, _ in eval_pages(2, seed=9100)]
    out = {}
    for dev in ("cuda", "cpu"):
        east, trba = load_quality_models(dev)
        pipe = Pipeline(east, trba, device=dev, fused=False)
        out[dev] = [words_of(pipe.predict(p)) for p in pages]
        east.nms = "device"
        out[dev + " scan"] = [words_of(east.predict(pages[0])["page"])]
    for name in ("", " scan"):
        card, cpu = out["cuda" + name], out["cpu" + name]
        check([len(ws) for ws in card] == [len(ws) for ws in cpu], (name, card, cpu))
        box = max(np.abs(np.subtract(a.polygon, b.polygon)).max()
                  for ws, wr in zip(card, cpu) for a, b in zip(ws, wr))
        print(f"micro{name or ' classic'}: words per page {[len(ws) for ws in card]}, max box |d| "
              f"card vs CPU {box:.3e} px")
        check(box <= 1e-2, box)
    texts = [[w.text for w in ws] for ws in out["cuda"]]
    print(f"micro classic texts, first page: {texts[0]}")
    check(texts == [[w.text for w in ws] for ws in out["cpu"]], "classic texts card vs CPU")


def npy_body(page) -> bytes:
    buf = io.BytesIO()
    np.save(buf, page)
    return buf.getvalue()


def http(url: str, body: bytes = None, timeout: float = 300.0):
    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def serve_clients(server, pages, n_requests: int, n_clients: int) -> list:
    """``n_requests`` ``.npy`` POSTs from ``n_clients`` threads → [(status,
    body, seconds)] in request order."""
    bodies = [npy_body(p) for p in pages]
    out = [None] * n_requests
    todo = list(range(n_requests))
    lock = threading.Lock()

    def client():
        while True:
            with lock:
                if not todo:
                    return
                i = todo.pop(0)
            t0 = time.perf_counter()
            status, body = http(f"http://127.0.0.1:{server.port}/ocr", bodies[i % len(bodies)])
            out[i] = (status, json.loads(body), time.perf_counter() - t0)

    threads = [threading.Thread(target=client) for _ in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "clients still running")
    return out


def metric(server, name: str) -> float:
    _, text = http(f"http://127.0.0.1:{server.port}/metrics")
    line = next(ln for ln in text.decode().splitlines() if ln.startswith(name + " "))
    return float(line.split()[1])


def serving(torch, det, rec, rng, k1, k2) -> None:
    """Phase 9: the in-process server over the micro pipeline and over the
    full-width one, then the command-line server as a subprocess."""
    from manuscript_tpu_torch import Pipeline
    from manuscript_tpu_torch.serve import OCRServer
    from manuscript_tpu_torch.utils.quality import load_quality_models
    from manuscript_tpu_torch.utils.synthetic import eval_pages

    torch.backends.cudnn.allow_tf32 = False
    micro = Pipeline(*load_quality_models("cuda"))
    pages = [p for p, _ in eval_pages(8, seed=9200)]
    server = OCRServer(micro, host="127.0.0.1", port=0, batch_wait_ms=50.0)
    server.start_background()
    try:
        got = serve_clients(server, pages, 8, 8)
        n_pages = metric(server, "ocr_pages_total")
    finally:
        server.shutdown()
    check(all(status == 200 for status, _, _ in got), [g[0] for g in got])
    texts = [body["text"] for _, body, _ in got]
    ref = [micro.get_text(micro.predict(p)) for p in pages]
    print(f"micro server: 8 concurrent requests, 200 each; /metrics pages {n_pages:.0f}; served "
          f"texts equal predict's: {sum(a == b for a, b in zip(texts, ref))} of 8")
    check(texts == ref and all(texts), (texts, ref))
    check(n_pages == 8, n_pages)

    torch.backends.cudnn.allow_tf32 = True
    det.max_boxes = 1024
    full = Pipeline(det, rec, beam_size=8, batch_pages=4)
    pages = [synthetic_page(rng) for _ in range(8)]
    server = OCRServer(full, host="127.0.0.1", port=0, batch_wait_ms=25.0)
    server.start_background()
    try:
        serve_clients(server, pages, 8, 8)  # warm-up: capacity, cuDNN plans, warm_next_bucket
        batches0, pages0 = metric(server, "ocr_batches_total"), metric(server, "ocr_pages_total")
        k1.launches = k2.launches = 0
        t0 = time.perf_counter()
        got = serve_clients(server, pages, 32, 8)
        wall = time.perf_counter() - t0
        launches = {"attention_step": k1.launches, "quad_iou": k2.launches}
        fill = ((metric(server, "ocr_pages_total") - pages0)
                / (metric(server, "ocr_batches_total") - batches0))
    finally:
        server.shutdown()
    check(all(status == 200 for status, _, _ in got), [g[0] for g in got])
    lat = np.array([sec for _, _, sec in got])
    for _, body, _ in got:
        for w in (w for b in body["page"]["blocks"] for w in b["words"]):
            check(np.all(np.isfinite(w["polygon"])) and np.isfinite(w["detection_confidence"]), w)
    print(f"full-width server: 32 requests from 8 clients in {wall:.4f} s = {32 / wall:.4f} pages/s; "
          f"latency p50 {np.percentile(lat, 50):.4f} s, p99 {np.percentile(lat, 99):.4f} s, max "
          f"{lat.max():.4f} s; mean batch fill {fill:.3f} pages; word capacity "
          f"{full._fused.max_words}, warmed buckets {sorted(full._fused._warmed_buckets)}; "
          f"launches around the 32 requests {launches}")
    # phase B (25 K1 steps) and both NMS calls of phase A for every batch
    check(launches["attention_step"] >= rec.max_length * 32 // 4
          and launches["quad_iou"] >= 2 * 32 // 4, launches)

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    home = tempfile.mkdtemp(prefix="chip_smoke_home_")
    env = dict(os.environ, HOME=home, MANUSCRIPT_TPU_ALLOW_RANDOM_INIT="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "manuscript_tpu_torch", "serve", "--host", "127.0.0.1",
         "--port", str(port)], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    )
    try:
        lines = []  # up to "serving OCR on ...", printed once the models are up
        while not (lines and "serving OCR" in lines[-1]):
            line = proc.stdout.readline()
            check(line != "", "serve subprocess ended: " + "".join(lines[-20:]))
            lines.append(line)
        first = lines[-1]
        t0 = time.perf_counter()
        _, body = http(f"http://127.0.0.1:{port}/healthz")
        health = json.loads(body)
        status, body = http(f"http://127.0.0.1:{port}/ocr", npy_body(pages[0]))
        page = json.loads(body)
        print(f"python -m manuscript_tpu_torch serve: {first.strip()}; /healthz {health}; one "
              f".npy POST: {status}, {sum(len(b['words']) for b in page['page']['blocks'])} boxes, "
              f"{time.perf_counter() - t0:.4f} s")
        check(health["backend"] == "cuda" and health["device"] == torch.cuda.get_device_name(0), health)
        check(status == 200, status)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    check(proc.poll() is not None, "serve subprocess still running")


def micro_step_inputs():
    """Phase 10's micro steps' inputs: the committed micro checkpoints'
    variables (flax layout), the TRBA token map, and the global batches as
    numpy: 8 crops of uniform pixels with their targets, and 2 pages of
    uniform pixels with two rendered pages' label maps at 64²."""
    from manuscript_tpu_torch.recognizers.charset import pack_targets
    from manuscript_tpu_torch.train.east_dataset import rasterize_quad_maps
    from manuscript_tpu_torch.utils.synthetic import VOCAB, render_page
    from manuscript_tpu_torch.utils.weights import msgpack_restore

    qdir = ROOT / "manuscript_tpu" / "configs" / "quality"
    raw = msgpack_restore(qdir / "trba_micro.msgpack")
    east_raw = msgpack_restore(qdir / "east_micro.msgpack")
    itos = [raw["itos"][str(i)] for i in range(len(raw["itos"]))]
    stoi = {s: i for i, s in enumerate(itos)}
    rng = np.random.default_rng(10)
    words = [str(VOCAB[int(i)]) for i in rng.integers(len(VOCAB), size=8)]
    crops = rng.integers(0, 256, (8, 32, 128, 3), dtype=np.uint8)
    text_in, target_y, _ = pack_targets(words, stoi, 12)
    pages, scores, geos = [], [], []
    for _ in range(2):
        _, ws = render_page(rng, page_h=256, page_w=192, n_rows=3, n_cols=1)
        pages.append(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
        score, geo = rasterize_quad_maps([w["quad"] * np.float32([64 / 192, 64 / 256]) for w in ws], 64)
        scores.append(score)
        geos.append(geo)
    return raw, east_raw, stoi, (crops, text_in, target_y), tuple(np.stack(a) for a in (pages, scores, geos))


MICRO_SCALE = 1e6  # the micro steps' SGD scale: the update is −S·g


def micro_steps(torch, dev, trba_batch, east_batch, group=None, east: bool = True,
                dtype=None, sync_bn: bool = True) -> list:
    """One TRBA step (dropout 0) and one EAST step (ASAM + SGD, OHEM, focal
    geometry, ``freeze_first``) from the micro checkpoints on ``dev``, SGD
    at lr 1 under the scale S (TRBA's plateau scale, EAST's learning rate)
    → [(loss, state dict on the CPU, trainable names, the step's seconds
    with the card synchronised before and after)] for TRBA (and EAST). The
    models compute in ``dtype`` (float32 by default; EAST's heads and loss
    stay float32 in a float64 model).
    With a process ``group`` the batches are this rank's slices, and the
    BatchNorms (each rank's own with ``sync_bn=False``: a wrong step), the
    losses and the gradients are the global batch's."""
    from manuscript_tpu_torch.models.east import EASTModel
    from manuscript_tpu_torch.models.layers import sync_batch_stats
    from manuscript_tpu_torch.models.trba import TRBAModel
    from manuscript_tpu_torch.train import east_train, optim, trba_train
    from manuscript_tpu_torch.utils.weights import params_from_jax

    raw, east_raw, stoi = MICRO[:3]
    model = TRBAModel(len(stoi), 64, stoi["<SOS>"], stoi["<EOS>"], stoi.get("<BLANK>"), "micro",
                      enc_dropout_p=0.0, dec_dropout_p=0.0)
    model.load_state_dict(params_from_jax(raw))
    model.to(dev, dtype or torch.float32)
    sync_batch_stats(model, group if sync_bn else None)
    params = dict(model.named_parameters())
    tx = optim.build_trba_optimizer("sgd", 1.0)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in zip(("image", "text_in", "target_y"), trba_batch)}
    opt_state = tx.init(params)
    sync = lambda: torch.cuda.synchronize(dev) if torch.device(dev).type == "cuda" else None
    sync()
    t0 = time.perf_counter()
    loss, _ = trba_train.train_step(model, tx, opt_state, params, batch, stoi["<PAD>"],
                                    lr_scale=MICRO_SCALE, group=group)
    loss = loss.item()  # waits for the step
    out = [(loss, {k: v.detach().cpu() for k, v in model.state_dict().items()}, list(params),
            time.perf_counter() - t0)]
    if east:
        model = EASTModel("resnet50-micro")
        model.load_state_dict(params_from_jax(east_raw))
        model.to(dev, dtype or torch.float32)
        sync_batch_stats(model, group if sync_bn else None)
        mask = east_train.freeze_mask(model, True)
        trainable = {k: p for k, p in model.named_parameters() if mask[k]}
        etx = optim.sgd(MICRO_SCALE, 0.9)
        state = east_train.EASTTrainState(model, etx.init(trainable), None)
        ebatch = [torch.as_tensor(a).to(dev) for a in east_batch]
        sync()
        t0 = time.perf_counter()
        eloss = east_train.train_step(state, etx, trainable, *ebatch, group=group).item()
        out.append((eloss, {k: v.detach().cpu() for k, v in model.state_dict().items()},
                    list(dict(model.named_parameters())), time.perf_counter() - t0))
    return out


PHASE10_BOUND = (1e-4, 1e-5, 1e-4)  # (gradient, loss, running statistics): float32 card vs CPU
# phase 13's float64 steps; EAST's heads and loss compute in float32 even so
FLOAT64_BOUND = {"TRBA": (1e-8, 1e-10, 1e-10), "EAST": (1e-6, 1e-6, 1e-10)}


def step_gap(torch, start: dict, ref, got, rel: float = PHASE10_BOUND[0]) -> tuple:
    """The distance of a micro step ``got`` from ``ref`` (both
    ``micro_steps`` entries, the same start): |d| of the loss; the largest
    |d| of a leaf's gradient (its update / −S) over the bound, ``rel`` of
    the leaf's largest entry plus ``rel`` / 100 of the largest entry of all
    (for the conv biases before a BatchNorm, whose gradient is 0); the
    running statistics' largest |d|. Prints the four worst leaves."""
    grad = lambda st: {k: (start[k] - st[k]).double() / MICRO_SCALE for k in ref[2]}
    g_ref, g_got = grad(ref[1]), grad(got[1])
    top = max(g.abs().max().item() for g in g_ref.values())
    ratios = sorted(((g_got[k] - g_ref[k]).abs().max().item()
                     / (rel * g_ref[k].abs().max().item() + rel / 100 * top), k) for k in g_ref)
    print(f"  worst leaves (|d| over the bound, leaf, its largest entry over the largest of all): "
          f"{[(round(r, 4), k, round(g_ref[k].abs().max().item() / top, 8)) for r, k in ratios[-4:]]}"
          f"; leaves over the bound {sum(r > 1 for r, _ in ratios)} of {len(ratios)}")
    dstat = max((got[1][k] - ref[1][k]).abs().max().item() for k in ref[1] if "running" in k)
    return abs(got[0] - ref[0]), ratios[-1][0], dstat


def within(gap: tuple, ref_loss: float, bound: tuple = PHASE10_BOUND) -> bool:
    dloss, dgrad, dstat = gap
    return dloss <= bound[1] * abs(ref_loss) and dgrad <= 1.0 and dstat <= bound[2]


def check_step(name: str, what: str, gap: tuple, ref_loss: float,
               bound: tuple = PHASE10_BOUND) -> None:
    dloss, dgrad, dstat = gap
    print(f"micro {name} train step, {what}: loss |d| {dloss:.3e} (of {ref_loss:.6f}); gradients "
          f"(update / -{MICRO_SCALE:g}) max |d| over the bound ({bound[0]:g} of a leaf's largest "
          f"entry) {dgrad:.3e}; running statistics max |d| {dstat:.3e}")
    check(within(gap, ref_loss, bound), (name, what, gap))


MICRO = None  # micro_step_inputs(), set where the steps run


def micro_train_steps(torch) -> None:
    """Phase 10, first part: ``micro_steps`` on the card and on the CPU, TF32
    off: each leaf's gradient on the card within 1e-4 of the leaf's largest
    entry of the CPU's (plus 1e-6 of the largest entry of all, for the conv
    biases before a BatchNorm, whose gradient is 0), the loss within 1e-5
    relative, the running statistics within 1e-4 (``step_gap``). The pixels
    are drawn uniformly (EAST's label maps are two rendered pages' at 64²):
    on near-white crops and pages the stem's float32 gradient is a difference
    of nearly equal sums, which the card's and the CPU's reduction orders
    round apart; under ASAM it sets the perturbation of the frozen stem, and
    the card's step then parted from the CPU's by 3 % of a leaf's largest
    entry in the first trainable block, in some runs and not in others."""
    from manuscript_tpu_torch.utils.weights import params_from_jax

    global MICRO
    MICRO = micro_step_inputs()
    start = [params_from_jax(MICRO[0]), params_from_jax(MICRO[1])]
    out = {dev: micro_steps(torch, dev, *MICRO[3:]) for dev in ("cuda", "cpu")}
    for name, card, cpu, st in zip(("TRBA", "EAST"), out["cuda"], out["cpu"], start):
        check_step(name, "card vs CPU", step_gap(torch, st, cpu, card), cpu[0])


@contextlib.contextmanager
def timed_steps(torch, module):
    """Inside: each call of ``module.train_step`` waits for the card before
    and after, and its seconds are appended to the list yielded. The
    trainers look the step up in their module, so their loops are timed."""
    real, seconds = module.train_step, []

    def step(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = real(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return result

    module.train_step = step
    try:
        yield seconds
    finally:
        module.train_step = real


def trba_full_training(torch, k1, tmp: Path) -> int:
    """Phase 10: ``TRBA.train`` at full width on rendered word crops → the K1
    steps counted around its validations."""
    from manuscript_tpu_torch import TRBA
    from manuscript_tpu_torch.models.trba import TRBAModel
    from manuscript_tpu_torch.train import optim, trba_train
    from manuscript_tpu_torch.train.trba_dataset import OCRDataset, collate_attention
    from manuscript_tpu_torch.recognizers.charset import default_charset
    from manuscript_tpu_torch.utils.synthetic import build_word_dataset, render_word
    from manuscript_tpu_torch.utils.weights import init_random_

    t0 = time.perf_counter()
    tsv, imgs = build_word_dataset(tmp / "words", 256, seed=1)
    vtsv, vimgs = build_word_dataset(tmp / "val_words", 64, seed=2)
    print(f"TRBA data: 256 training and 64 validation crops written as PNG in "
          f"{time.perf_counter() - t0:.2f} s")
    cfg = dict(exp_root=str(tmp / "trba"), cnn_stage_plan="full", img_h=64, img_w=256,
               hidden_size=256, max_len=25, batch_size=64, lr=1e-3, optimizer="adam",
               grad_clip=5.0, eval_beam=True, beam_size=8, epochs=2, seed=0)
    per_epoch = -(-64 // 64) * (26 + 25)  # one greedy (max_len + 1) and one beam (max_len) pass
    torch.cuda.reset_peak_memory_stats()
    k1.launches = 0
    with timed_steps(torch, trba_train) as first_s:
        first = TRBA.train(tsv, imgs, vtsv, vimgs, config=cfg)
    launches = [k1.launches]
    exp = Path(first["exp_dir"])
    k1.launches = 0
    with timed_steps(torch, trba_train) as again_s:
        again = TRBA.train(tsv, imgs, vtsv, vimgs,
                           config=dict(cfg, exp_name=exp.name, resume=str(exp), epochs=3))
    launches.append(k1.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    history = first["history"] + again["history"]
    steps = first_s[1:] + again_s[1:]
    med = statistics.median(steps)
    print(f"TRBA.train full width (64×256, hidden 256, 194 tokens, batch 64, Adam 1e-3, clip 5, "
          f"dropout on): epochs {[h['epoch'] for h in history]} (the third resumed from "
          f"last_state.msgpack); median step {med:.4f} s over {len(steps)} steps after each run's "
          f"first = {64 / med:.1f} samples/s; all steps {[round(s, 4) for s in first_s + again_s]}; "
          f"epoch seconds {[round(h['time_s'], 2) for h in history]}; peak memory {peak:.2f} GiB")
    for h in history:
        print(f"  epoch {h['epoch']}: train loss {h['train_loss']:.4f}, val loss {h['val_loss']:.4f}, "
              f"greedy acc {h['val_acc']:.4f} CER {h['val_cer']:.4f}, beam acc "
              f"{h['beam']['accuracy']:.4f} CER {h['beam']['cer']:.4f}")
        check(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"]), h)
    print(f"K1 steps in training's validation: {launches} for 2 + 1 epochs of one 64-crop batch "
          f"(expected {per_epoch} a epoch: 26 greedy + 25 beam)")
    check(launches == [2 * per_epoch, per_epoch], launches)

    rec = TRBA(weights_path=exp / "checkpoints" / "best_acc.msgpack")
    crops = [render_word(w, np.random.default_rng(3)) for w in ("ink", "codex", "margin")]
    got = rec.predict(crops, mode="beam")
    print(f"best_acc.msgpack in TRBA(weights_path=...): {[(r['text'], round(r['confidence'], 4)) for r in got]}")
    check(len(got) == 3 and all(np.isfinite(r["confidence"]) for r in got), got)

    itos = default_charset()
    stoi = {s: i for i, s in enumerate(itos)}
    ds = OCRDataset(tsv, imgs, stoi, max_len=25, img_h=64, img_w=256)
    batch = collate_attention([ds[i] for i in range(64)], stoi, 25)
    batch = {k: torch.from_numpy(batch[k]).cuda() for k in ("image", "text_in", "target_y")}
    model = init_random_(TRBAModel(len(itos), 256, stoi["<SOS>"], stoi["<EOS>"], stoi.get("<BLANK>")), 0).cuda()
    params = dict(model.named_parameters())
    tx = optim.build_trba_optimizer("adam", 1e-3, 0.0, 5.0)
    state, gen = tx.init(params), torch.Generator(device="cuda").manual_seed(0)
    losses = []
    for _ in range(30):
        loss, state = trba_train.train_step(model, tx, state, params, batch, stoi["<PAD>"], generator=gen)
        losses.append(loss)
    losses = [float(v) for v in torch.stack(losses).cpu()]
    print(f"30 steps on one fixed batch of 64: loss {losses[0]:.4f} → {losses[-1]:.4f}")
    check(losses[-1] < losses[0], losses)

    bf16 = TRBA.train(tsv, imgs, vtsv, vimgs, config=dict(cfg, exp_root=str(tmp / "trba_bf16"), epochs=1,
                                                         eval_beam=False, compute_dtype="bfloat16"))
    b_losses = bf16["history"][0]["train_losses"]
    print(f"one epoch under compute_dtype='bfloat16': step losses {[round(v, 4) for v in b_losses]}, "
          f"val loss {bf16['val_loss']:.4f}, {bf16['history'][0]['time_s']:.2f} s")
    check(np.all(np.isfinite(b_losses)) and np.isfinite(bf16["val_loss"]), b_losses)
    return sum(launches)


def east_full_training(torch, tmp: Path) -> None:
    """Phase 10: ``EAST.train`` at the trainer's defaults (resnet101, 1024²,
    batch 3, ASAM + SGD, OHEM, focal geometry, multiscale, freeze_first)."""
    from manuscript_tpu_torch import EAST
    from manuscript_tpu_torch.train import east_train
    from manuscript_tpu_torch.utils.synthetic import build_page_dataset

    t0 = time.perf_counter()
    coco, pages, _ = build_page_dataset(tmp / "pages", 6, seed=3)
    vcoco, vpages, _ = build_page_dataset(tmp / "val_pages", 3, seed=4)
    print(f"EAST data: 6 training and 3 validation pages (1024×768, 24 words each) with COCO "
          f"labels, written in {time.perf_counter() - t0:.2f} s")
    common = dict(experiment_root=str(tmp / "east"), target_size=1024, batch_size=3)
    runs = {}
    for name, kw in (("GPU-resident (cache_device=True), ASAM + SGD", dict(epochs=2, cache_device=True)),
                     ("streamed, host resize, ASAM + SGD", dict(epochs=1)),
                     ("RAdam + Lookahead + EMA, GPU-resident, 6 steps", dict(
                         epochs=3, cache_device=True, use_sam=False, use_ema=True))):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with timed_steps(torch, east_train) as s:
            out = EAST.train(pages, coco, vpages, vcoco, model_name=f"run{len(runs)}", **common, **kw)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[name] = out
        print(f"EAST.train resnet101 at 1024², {name}: step seconds {[round(x, 4) for x in s]} "
              f"(median after the first {statistics.median(s[1:]):.4f}); wall {wall:.2f} s; peak "
              f"memory {peak:.2f} GiB")
        for h in out["history"]:
            print(f"  epoch {h['epoch']}: train loss {h['train_loss']:.4f}, val loss "
                  f"{h['val_loss']:.4f}, soft dice {h['val_dice']:.4f}, {h['time']:.2f} s")
            check(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"]), h)
    best = Path(runs["GPU-resident (cache_device=True), ASAM + SGD"]["exp_dir"]) / "checkpoints" / "best.msgpack"
    det = EAST(best, backbone="resnet101", target_size=1024)
    page = np.full((1024, 768, 3), 235, np.uint8)
    result = det.predict(page)
    print(f"best.msgpack in EAST(weights_path=...): predict → {len(words_of(result['page']))} boxes")


def training(torch, k1) -> int:
    """Phase 10 → the K1 steps of training's validations."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    micro_train_steps(torch)
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        launches = trba_full_training(torch, k1, Path(tmp))
        east_full_training(torch, Path(tmp))
    return launches


class _RefState:
    """A state dict of the reference's layout, filled from a seeded torch
    generator with LeCun-scaled weights and non-trivial BatchNorm."""

    def __init__(self, torch, gen):
        self.torch, self.gen, self.s = torch, gen, {}

    def arr(self, *shape, scale=1.0):
        return self.torch.randn(shape, generator=self.gen) * scale

    def bn(self, key, c):
        t = self.torch
        self.s[f"{key}.weight"] = t.rand(c, generator=self.gen) * 0.5 + 0.5
        self.s[f"{key}.bias"] = self.arr(c, scale=0.1)
        self.s[f"{key}.running_mean"] = self.arr(c, scale=0.1)
        self.s[f"{key}.running_var"] = t.rand(c, generator=self.gen) + 0.5
        self.s[f"{key}.num_batches_tracked"] = t.tensor(1)

    def conv(self, key, o, i, k, bias=False):
        self.s[f"{key}.weight"] = self.arr(o, i, k, k, scale=(i * k * k) ** -0.5)
        if bias:
            self.s[f"{key}.bias"] = self.arr(o, scale=0.1)

    def linear(self, key, o, i, bias=True):
        self.s[f"{key}.weight"] = self.arr(o, i, scale=i ** -0.5)
        if bias:
            self.s[f"{key}.bias"] = self.arr(o, scale=0.1)

    def lstm(self, key, i, h, suffix=""):
        for name, cols in (("weight_ih", i), ("weight_hh", h)):
            self.s[f"{key}.{name}{suffix}"] = self.arr(4 * h, cols, scale=cols ** -0.5)
        for name in ("bias_ih", "bias_hh"):
            self.s[f"{key}.{name}{suffix}"] = self.arr(4 * h, scale=0.1)


def reference_east_state(torch, gen) -> dict:
    """EAST-R50 with every key ``convert_east`` reads."""
    b = _RefState(torch, gen)
    bb = "backbone.extractor"
    b.conv(f"{bb}.conv1", 64, 3, 7)
    b.bn(f"{bb}.bn1", 64)
    planes, in_ch = 64, 64
    for stage, blocks in enumerate((3, 4, 6, 3), start=1):
        for i in range(blocks):
            base = f"{bb}.layer{stage}.{i}"
            b.conv(f"{base}.conv1", planes, in_ch if i == 0 else planes * 4, 1)
            b.bn(f"{base}.bn1", planes)
            b.conv(f"{base}.conv2", planes, planes, 3)
            b.bn(f"{base}.bn2", planes)
            b.conv(f"{base}.conv3", planes * 4, planes, 1)
            b.bn(f"{base}.bn3", planes * 4)
            if i == 0:
                b.conv(f"{base}.downsample.0", planes * 4, in_ch, 1)
                b.bn(f"{base}.downsample.1", planes * 4)
        in_ch, planes = planes * 4, planes * 2
    for n, (cin, mid, cout) in enumerate(
        [(2048, 512, 512), (1536, 256, 256), (768, 128, 128), (384, 64, 32)], start=1
    ):
        b.conv(f"decoder.block{n}.conv1x1.0", mid, cin, 1, bias=True)
        b.bn(f"decoder.block{n}.conv1x1.1", mid)
        b.conv(f"decoder.block{n}.conv3x3.0", cout, mid, 3, bias=True)
        b.bn(f"decoder.block{n}.conv3x3.1", cout)
    b.conv("output_head.score_map", 1, 32, 1, bias=True)
    b.conv("output_head.geo_map", 8, 32, 1, bias=True)
    return b.s


def reference_trba_state(torch, gen, num_classes: int = 194, hidden: int = 256) -> dict:
    """TRBA (full SEResNet31 plan) with every key ``convert_trba`` reads."""
    b = _RefState(torch, gen)
    b.conv("cnn.conv0.0", 64, 3, 3)
    b.bn("cnn.conv0.1", 64)
    b.conv("cnn.conv0.3", 128, 64, 3)
    b.bn("cnn.conv0.4", 128)
    in_planes = 128
    for stage, (planes, blocks, stride) in enumerate(
        [(256, 1, 2), (256, 2, 1), (512, 5, 2), (512, 3, 1)], start=1
    ):
        for i in range(blocks):
            base = f"cnn.layer{stage}.{i}"
            b.conv(f"{base}.conv1", planes, in_planes if i == 0 else planes, 3)
            b.bn(f"{base}.bn1", planes)
            b.conv(f"{base}.conv2", planes, planes, 3)
            b.bn(f"{base}.bn2", planes)
            b.linear(f"{base}.se.fc.0", planes // 16, planes, bias=False)
            b.linear(f"{base}.se.fc.2", planes, planes // 16, bias=False)
            if i == 0 and (stride != 1 or in_planes != planes):
                b.conv(f"{base}.downsample.0", planes, in_planes, 1)
                b.bn(f"{base}.downsample.1", planes)
        in_planes = planes
    for n in (0, 3):
        b.conv(f"cnn.conv_out.{n}", 512, 512, 2)
        b.bn(f"cnn.conv_out.{n + 1}", 512)
    for i, cin in ((0, 512), (1, hidden)):
        b.lstm(f"enc_rnn.{i}.rnn", cin, hidden, "_l0")
        b.lstm(f"enc_rnn.{i}.rnn", cin, hidden, "_l0_reverse")
        b.linear(f"enc_rnn.{i}.linear", hidden, 2 * hidden)
    cell = "attn.attention_cell"
    b.linear(f"{cell}.i2h", hidden, hidden, bias=False)
    b.linear(f"{cell}.h2h", hidden, hidden)
    b.linear(f"{cell}.score", 1, hidden, bias=False)
    b.lstm(f"{cell}.rnn", hidden + num_classes, hidden)
    b.linear("attn.generator", num_classes, hidden)
    return b.s


@contextlib.contextmanager
def environment(**values):
    """Inside: the environment with ``values`` set (None: removed)."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def constructed(fn):
    """``fn()`` with its standard output captured → (result, output)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn()
    print(out.getvalue(), end="")
    return result, out.getvalue()


def fetched_reference_models(torch, tmp: Path):
    """Phase 11a: the reference-layout checkpoints through the first-use
    fetch → (EAST, TRBA) on the card, converted."""
    from manuscript_tpu_torch import EAST, TRBA
    from manuscript_tpu_torch.utils import weights as W

    gen = torch.Generator().manual_seed(11)
    release = tmp / "release"
    release.mkdir()
    t0 = time.perf_counter()
    east_state, trba_state = reference_east_state(torch, gen), reference_trba_state(torch, gen)
    torch.save({"model_state": east_state}, release / "east.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in trba_state.items()}}, release / "trba.pth")
    (release / "trba.json").write_text(json.dumps(
        {"max_len": 25, "hidden_size": 256, "img_h": 64, "img_w": 256}))
    print(f"reference-layout checkpoints: EAST-R50 {len(east_state)} tensors "
          f"({(release / 'east.pth').stat().st_size / 2**20:.1f} MiB), TRBA {len(trba_state)} tensors "
          f"({(release / 'trba.pth').stat().st_size / 2**20:.1f} MiB), written in "
          f"{time.perf_counter() - t0:.2f} s")
    urls = {f"MANUSCRIPT_TPU_{n}_URL": (release / f).as_uri()
            for n, f in (("EAST", "east.pth"), ("TRBA", "trba.pth"), ("TRBA_CONFIG", "trba.json"))}
    gone = {k: (tmp / "gone").as_uri() for k in urls}
    (tmp / "home").mkdir()
    with environment(HOME=tmp / "home", MANUSCRIPT_TPU_CACHE=tmp / "cache",
                     MANUSCRIPT_TPU_NO_DOWNLOAD=None, **urls):
        t0 = time.perf_counter()
        (det, rec), log = constructed(lambda: (EAST(allow_random_init=False),
                                               TRBA(allow_random_init=False)))
        seconds = time.perf_counter() - t0
        counts = [int(n) for n in re.findall(r"\[convert\] loaded (\d+) tensors", log)]
        print(f"EAST() and TRBA() with no path: fetched over file://, converted and loaded in "
              f"{seconds:.2f} s; loaded tensors {counts} of {len(det.model.state_dict())} and "
              f"{len(rec.model.state_dict())}; TRBA config max_len {rec.max_length}, hidden "
              f"{rec.hidden_size}, plan {rec.cnn_stage_plan}")
        check(counts == [len(det.model.state_dict()), len(rec.model.state_dict())], counts)
        check("skipped" not in log and log.count("Downloading") == 3, log)
        check((rec.max_length, rec.hidden_size, rec.img_h, rec.cnn_stage_plan) == (25, 256, 64, "full"),
              rec.config_path)
        with environment(**gone):
            (det2, rec2), log = constructed(lambda: (EAST(allow_random_init=False),
                                                     TRBA(allow_random_init=False)))
        check("Downloading" not in log, log)
        check(det2.weights_path == det.weights_path and rec2.model_path == rec.model_path,
              (det2.weights_path, rec2.model_path))
        for a, b in ((det, det2), (rec, rec2)):
            sa, sb = a.model.state_dict(), b.model.state_dict()
            check(all(torch.equal(sa[k], sb[k]) for k in sa), "cache copy differs")
        del det2, rec2
        print(f"second construction: from the cache ({det.weights_path}, {rec.model_path}), "
              "nothing fetched, the same weights")

        saved = W.PINNED_HASHES_FILE
        W.PINNED_HASHES_FILE = tmp / "release_hashes.json"
        W.pin_sha256("east", "0" * 64)
        refused = None
        try:
            with environment(MANUSCRIPT_TPU_CACHE=tmp / "cache2"), \
                    warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                EAST(allow_random_init=False)
        except W.MissingWeightsError as e:
            refused = e
        finally:
            W.PINNED_HASHES_FILE = saved
        left = [p for p in (tmp / "cache2").rglob("*") if p.is_file()]
        msgs = [str(w.message) for w in caught]
        check(refused is not None and not left and any("sha256 mismatch" in m for m in msgs),
              (refused, left, msgs))
        print(f"a pinned wrong sha256: refused ({msgs[0][:80]}...), no file left in the cache")
    return det, rec


def far_from_words(page_obj, shape, margin: int = 20):
    """Pixels more than ``margin`` px from every word box and more than 6 px
    from every reading-order line."""
    from PIL import Image, ImageDraw

    far = np.ones(shape[:2], bool)
    centers = []
    for w_ in words_of(page_obj):
        poly = np.asarray(w_.polygon, np.float64)
        x0, y0 = np.floor(poly.min(0)).astype(int) - margin
        x1, y1 = np.ceil(poly.max(0)).astype(int) + margin
        far[max(y0, 0) : max(y1, 0), max(x0, 0) : max(x1, 0)] = False
        centers.append(tuple(poly.mean(0)))
    lines = Image.new("L", (shape[1], shape[0]), 0)
    draw = ImageDraw.Draw(lines)
    for p, c in zip(centers, centers[1:]):
        draw.line([p, c], fill=1, width=13)
    return far & (np.asarray(lines) == 0)


def vis_pages(torch, det, rec, rng, k1, k2, tmp: Path) -> int:
    """Phase 11b: ``Pipeline.predict(vis=True)``, ``process_batch(vis=True)``
    and the CLI's ``--vis`` with the converted models → K1 steps of the 3
    ``predict`` pages."""
    from manuscript_tpu_torch import Pipeline
    from manuscript_tpu_torch.ops.image import decode_png, encode_png

    pages = [synthetic_page(rng) for _ in range(4)]
    word_sized_boxes(torch, det, pages[0])
    pipe = Pipeline(det, rec, beam_size=8)
    pipe.predict(pages[0], vis=True)  # warm-up: cuDNN plans, word capacity
    torch.cuda.synchronize()
    k1.launches = k2.launches = 0
    drawn, with_vis = [], []
    for page in pages[1:]:
        t0 = time.perf_counter()
        drawn.append(pipe.predict(page, vis=True))
        torch.cuda.synchronize()
        with_vis.append(time.perf_counter() - t0)
    launches = {"attention_step": k1.launches, "quad_iou": k2.launches}
    plain, without = [], []
    for page in pages[1:]:
        t0 = time.perf_counter()
        plain.append(pipe.predict(page))
        torch.cuda.synchronize()
        without.append(time.perf_counter() - t0)
    print(f"Pipeline.predict(vis=True), converted weights, 3 pages 1600×1200: seconds a page "
          f"{[round(x, 4) for x in with_vis]} (mean {statistics.mean(with_vis):.4f}); without vis "
          f"{[round(x, 4) for x in without]} (mean {statistics.mean(without):.4f}); launches {launches}")
    check(launches["attention_step"] == 25 * 3 and launches["quad_iou"] >= 2 * 3, launches)
    for (page_obj, img), page, ref in zip(drawn, pages[1:], plain):
        words, ref_words = words_of(page_obj), words_of(ref)
        check_finite(words)
        check(len(words) == len(ref_words) > 0, (len(words), len(ref_words)))
        shift = max(np.abs(np.subtract(a.polygon, b.polygon)).max() for a, b in zip(words, ref_words))
        check(shift <= 1e-2, shift)
        arr = np.asarray(img)
        check(arr.shape == page.shape, arr.shape)
        far = far_from_words(page_obj, page.shape)
        dark = (page.astype(np.float32) * np.float32(1 - 0.3)).astype(np.uint8)
        check(far.mean() > 0.05 and np.array_equal(arr[far], dark[far]), far.mean())
        print(f"  {len(words)} words, texts {sum(bool(w.text) for w in words)}; box shift vs "
              f"no vis {shift:.2e} px; far pixels {far.mean():.3f} of the page, all the page "
              "darkened by 0.3")

    batch = [synthetic_page(rng) for _ in range(8)]
    k1.launches = 0
    t0 = time.perf_counter()
    out = pipe.process_batch(batch, vis=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(len(out) == 8 and all(np.asarray(im).shape == pg.shape for (_, im), pg in zip(out, batch)),
          len(out))
    print(f"process_batch(vis=True) on 8 pages: {dt:.4f} s ({8 / dt:.4f} pages/s), K1 steps "
          f"{k1.launches}, {sum(len(words_of(p)) for p, _ in out)} words")

    path = tmp / "page.png"
    path.write_bytes(encode_png(pages[1]))
    env = dict(os.environ, HOME=str(tmp / "home"), MANUSCRIPT_TPU_CACHE=str(tmp / "cache"))
    env.pop("MANUSCRIPT_TPU_ALLOW_RANDOM_INIT", None)
    commands = {"ocr": ["ocr", str(path), "--vis", str(tmp / "ocr.png"), "--out", str(tmp / "ocr.json")],
                "detect": ["detect", str(path), "--vis", str(tmp / "detect.png"),
                           "--thresh", f"{det.score_thresh:.6f}"]}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, "-m", "manuscript_tpu_torch", *args], cwd=ROOT,
                                    env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, args in commands.items()}
    try:
        logs = {name: proc.communicate(timeout=400)[0] for name, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    for name, proc in procs.items():
        check(proc.returncode == 0, f"{name}: {logs[name][-3000:]}")
        img = decode_png((tmp / f"{name}.png").read_bytes())
        check(img.shape == pages[1].shape, img.shape)
    n_detected = int(re.search(r": (\d+) words", logs["detect"]).group(1))
    check(n_detected == 0 or not np.array_equal(img, pages[1]), n_detected)  # words are drawn
    print(f"CLI ocr --vis and detect --vis (subprocesses, weights from the cache, run at once): "
          f"{time.perf_counter() - t0:.2f} s; both PNGs decode to {pages[1].shape}; "
          f"detect says {logs['detect'].strip().splitlines()[-1]!r}")
    return launches["attention_step"]


def tps_through_k1(torch, k1) -> int:
    """Phase 11c: ``TRBAModel(use_tps=True)`` at full width through K1, and a
    micro one on the card against the CPU → K1 steps of the full-width beam."""
    from manuscript_tpu_torch.models.trba import TRBAModel
    from manuscript_tpu_torch.recognizers import TRBA
    from manuscript_tpu_torch.recognizers.trba import sequence_confidence
    from manuscript_tpu_torch.utils.quality import QUALITY_DIR
    from manuscript_tpu_torch.utils.weights import init_random_

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    plain = init_random_(TRBAModel(194, 256), 2)
    tps = init_random_(TRBAModel(194, 256, use_tps=True), 3)
    tps.load_state_dict(plain.state_dict(), strict=False)  # shared weights, identity TPS
    plain, tps = plain.to(dev).eval(), tps.to(dev).eval()
    rng = np.random.default_rng(7)
    strip = np.stack([np.full((64, 256, 3), int(v), np.uint8) for v in rng.integers(150, 256, 256)])
    for i, (x0, w) in enumerate(zip(rng.integers(0, 60, 256), rng.integers(60, 190, 256))):
        strip[i, 18:46, x0 : x0 + w] = rng.integers(0, 90, (28, w, 1), dtype=np.uint8)
    x = (torch.from_numpy(strip).to(dev).float() / 255.0 - 0.5) / 0.5
    with torch.inference_mode():
        tps.beam(x[:16], 25, 8), plain.beam(x[:16], 25, 8)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1.launches = 0
        logits_t, preds_t = tps.beam(x, 25, 8)
        torch.cuda.synchronize()
        steps = k1.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        logits_p, preds_p = plain.beam(x, 25, 8)
        conf_t = sequence_confidence(logits_t, preds_t, 2)[1]
        conf_p = sequence_confidence(logits_p, preds_p, 2)[1]
        differ = (preds_t != preds_p).any(1)
        conf_gap = float((conf_t - conf_p)[differ].abs().max()) if differ.any() else 0.0
        enc = {}
        for name, m in (("tps", tps), ("plain", plain), ("tps ", tps), ("plain ", plain)):
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m.encode(x)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            enc.setdefault(name.strip(), []).append(statistics.median(times))
    print(f"TRBAModel(use_tps=True) full width, 256 crops beam 8 (R = 2048): {steps} K1 steps, "
          f"peak memory {peak:.2f} GiB; tokens equal to the plain model's on "
          f"{int((~differ).sum())} of 256 rows, the others within {conf_gap:.2e} in confidence; "
          f"encode seconds (median of 5, in turns) with TPS {enc['tps']}, without {enc['plain']}")
    check(steps == 25, steps)
    # the identity warp moves pixels by ~1e-4: a row may read otherwise only
    # as a near-tie, its confidence within 1e-4 of the plain model's
    check(conf_gap <= 1e-4, (int(differ.sum()), conf_gap))

    rec = TRBA(QUALITY_DIR / "trba_micro.msgpack", device="cpu")
    micro = init_random_(TRBAModel(len(rec.itos), rec.hidden_size, rec.sos_id, rec.eos_id,
                                   rec.blank_id, rec.cnn_stage_plan, use_tps=True), 0)
    micro.load_state_dict(rec.model.state_dict(), strict=False)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        dense = micro.tps.localization.Dense_1
        dense.weight.copy_(torch.randn(dense.weight.shape, generator=gen) * 0.02)
    micro.eval()
    xm = torch.rand((16, rec.img_h, rec.img_w, 3), generator=gen) * 2 - 1
    with torch.inference_mode():
        ref_logits, ref = micro.beam(xm, rec.max_length, 4)
        micro.to(dev)
        k1.launches = 0
        logits, got = micro.beam(xm.to(dev), rec.max_length, 4)
        torch.cuda.synchronize()
    err = float((logits.cpu() - ref_logits).abs().max())
    print(f"micro TRBAModel(use_tps=True), warping TPS: card == CPU tokens "
          f"{bool(torch.equal(got.cpu(), ref))}, logits max |d| {err:.3e} (bound 1e-3), K1 steps "
          f"{k1.launches}")
    check(torch.equal(got.cpu(), ref) and err <= 1e-3 and k1.launches == rec.max_length, err)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    return steps


def collage_on_card(torch, det, rng) -> None:
    """Phase 11d: ``create_collage`` of the card's maps of one page."""
    from manuscript_tpu_torch.ops.image import detector_preprocess_host
    from manuscript_tpu_torch.utils.visualize import create_collage

    page = detector_preprocess_host(synthetic_page(rng), det.target_size)
    with torch.inference_mode():
        score, geo = det.maps(torch.from_numpy(page).to(det.device)[None])
    sc, ge = score[0].float().cpu().numpy(), geo[0].float().cpu().numpy()
    t0 = time.perf_counter()
    collage = create_collage(page, sc, ge, gt_quads=None, pred_score=sc, pred_geo=ge)
    print(f"create_collage of the card's maps ({sc.shape}, {ge.shape}): {collage.shape} "
          f"{collage.dtype} in {time.perf_counter() - t0:.3f} s")
    check(collage.shape == (640, 3200, 3) and collage.dtype == np.uint8, collage.shape)


def reference_weights_tps_vis(torch, rng, k1, k2) -> dict:
    """Phase 11 → the K1 steps of its runs."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ref_"))
    try:
        torch.backends.cudnn.allow_tf32 = True
        det, rec = fetched_reference_models(torch, tmp)
        vis_steps = vis_pages(torch, det, rec, rng, k1, k2, tmp)
        tps_steps = tps_through_k1(torch, k1)
        collage_on_card(torch, det, rng)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"Pipeline.predict(vis=True), 3 pages": vis_steps, "TRBAModel(use_tps=True).beam": tps_steps}


def subprocess_lines(args, timeout: float, env=None) -> str:
    """Run ``python args`` from the checkout's root; its output printed; a
    non-zero exit fails the phase."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout)
    print(f"$ python {' '.join(args)}  ({time.perf_counter() - t0:.1f} s, exit {out.returncode})")
    print(out.stdout.rstrip())
    check(out.returncode == 0, out.stderr[-4000:])
    return out.stdout


def print_split(what: str, split: dict, regions, per: int, outer: bool = False) -> None:
    """A ``device_split``: each region's device ms and launches per
    occurrence, the device work outside the regions (outside the first,
    when ``outer``: it holds the others), the window's busy share, and the
    top 10 kernels.
    Autograd runs the backward pass on a thread of its own, so a region on
    the calling thread holds the backward's launch, not its kernels: they
    are in the rest."""
    print(f"{what}: trace window {split['window_ms']:.3f} ms, device {split['device_ms']:.3f} ms "
          f"(busy share {split['busy']:.4f}), {split['launches']} device launches; per time:")
    for name in regions:
        r = split["regions"].get(name)
        check(r is not None and r["count"] == per and r["launches"] > 0, (name, r))
        print(f"   {name}: {r['device_ms'] / per:.3f} device ms, {r['launches'] / per:.0f} launches")
    top = regions[:1] if outer else regions
    inside = [split["regions"][n] for n in top]
    print(f"   outside {', '.join(top)}: {(split['device_ms'] - sum(r['device_ms'] for r in inside)) / per:.3f} "
          f"device ms, {(split['launches'] - sum(r['launches'] for r in inside)) / per:.0f} launches")
    for name, (n, ms) in list(split["kernels"].items())[:10]:
        print(f"   {ms:10.3f} ms {n:6d}×  {name[:110]}")


def profiler_split(torch, k1, det, rec, rng) -> None:
    """Phase 12, first part: ``utils.profiling.trace``/``annotate``/
    ``device_split`` over 3 full-width TRBA training steps (phase 10's
    configuration, batch 64), 2 EAST ASAM steps at the trainer's defaults
    and one ``process_batch`` of 4 full-width pages (its phase-B pass)."""
    from manuscript_tpu_torch import Pipeline
    from manuscript_tpu_torch.models.east import EASTModel
    from manuscript_tpu_torch.models.trba import TRBAModel
    from manuscript_tpu_torch.recognizers.charset import default_charset, pack_targets
    from manuscript_tpu_torch.train import east_train, optim, trba_train
    from manuscript_tpu_torch.utils.profiling import annotate, device_split, trace
    from manuscript_tpu_torch.utils.synthetic import VOCAB
    from manuscript_tpu_torch.utils.weights import init_random_

    logdir = Path(tempfile.mkdtemp(prefix="chip_smoke_trace_"))
    try:
        itos = default_charset()
        stoi = {c: i for i, c in enumerate(itos)}
        model = init_random_(TRBAModel(len(itos), 256, stoi["<SOS>"], stoi["<EOS>"],
                                       stoi.get("<BLANK>")), 0).cuda()
        params = dict(model.named_parameters())
        tx = optim.build_trba_optimizer("adam", 1e-3, 0.0, 5.0)
        state = [tx.init(params)]
        words = [str(VOCAB[int(i)]) for i in rng.integers(len(VOCAB), size=64)]
        text_in, target_y, _ = pack_targets(words, stoi, 25)
        batch = {"image": torch.from_numpy(rng.integers(0, 256, (64, 64, 256, 3), dtype=np.uint8)),
                 "text_in": torch.from_numpy(text_in), "target_y": torch.from_numpy(target_y)}
        batch = {k: v.cuda() for k, v in batch.items()}
        gen = torch.Generator(device="cuda").manual_seed(0)

        def trba_steps(n):
            for _ in range(n):
                _, state[0] = trba_train.train_step(model, tx, state[0], params, batch,
                                                    stoi["<PAD>"], generator=gen)

        trba_steps(1)  # warm
        with trace(logdir) as prof:
            trba_steps(3)
        print_split("3 TRBA training steps (full width, batch 64, Adam, dropout on)",
                    device_split(prof), ("trba.forward", "trba.backward", "trba.optimizer"), 3)
        del model, params, state, batch

        east = init_random_(EASTModel("resnet101"), 0).cuda()
        mask = east_train.freeze_mask(east, True)
        trainable = {k: p for k, p in east.named_parameters() if mask[k]}
        etx, _ = optim.build_east_optimizer(1e-3, steps_per_epoch=2, use_sam=True)
        est = east_train.EASTTrainState(east, etx.init(trainable), None)
        image = torch.from_numpy(rng.integers(0, 256, (3, 1024, 1024, 3), dtype=np.uint8)).cuda()
        score = (torch.rand(3, 256, 256, device="cuda") > 0.9).float()
        geo = torch.randn(3, 256, 256, 8, device="cuda") * 10

        def east_steps(n):
            for _ in range(n):
                east_train.train_step(est, etx, trainable, image, score, geo)

        east_steps(1)  # warm
        with trace(logdir) as prof:
            east_steps(2)
        print_split("2 EAST ASAM steps (resnet101, 1024², batch 3, SGD, OHEM, focal, "
                    "freeze_first)", device_split(prof),
                    ("sam.first_pass", "sam.second_pass", "east.update"), 2)
        del east, trainable, est, image
        torch.cuda.empty_cache()

        pipe = Pipeline(det, rec, beam_size=8, batch_pages=4)
        pages = [synthetic_page(rng) for _ in range(4)]
        pipe.process_batch(pages)  # warm
        k1.launches = 0
        with trace(logdir) as prof:
            with annotate("process_batch"):
                pipe.process_batch(pages)
        split = device_split(prof)
        print_split("process_batch, 4 full-width pages (one chunk)", split,
                    ("process_batch", "fused.phase_a", "fused.phase_b"), 1, outer=True)
        check(k1.launches == rec.max_length, k1.launches)
        print(f"   phase B's pass: {split['regions']['fused.phase_b']['launches']} device launches "
              f"for {rec.max_length} K1 steps at {pipe._fused.chunk_timings[0]['slots']} slots a "
              f"page (PERF.md §3 guessed ~3000 eager ops)")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)


def bench_on_card(smi: str) -> None:
    """Phase 12: ``python -m manuscript_tpu_torch bench`` at full size, then
    ``--perf-gate``. Every line parses, is finite and names the card; the
    primary comes first; both MFUs lie in (0, 1.05]; the quality lines
    (phase 7's pages and settings) equal the JAX package's CPU numbers
    within phase 7's tolerances."""
    ref = json.loads((ROOT / "manuscript_tpu_torch" / "configs" / "quality_reference.json").read_text())
    out = subprocess_lines(["-m", "manuscript_tpu_torch", "bench"], timeout=1200)
    lines = {}
    for ln in out.splitlines():
        if ln.startswith("{"):
            row = json.loads(ln)
            lines[row["metric"]] = row
            check(np.isfinite(row["value"]) and row["device"] == smi, row)
    check(next(iter(lines)) == "e2e_pipeline_pages_per_sec", list(lines))
    for name in ("fused_program_mfu", "fused_e2e_mfu", "east_train_step_mfu", "trba_train_step_mfu"):
        check(0.0 < lines[name]["value"] <= 1.05, lines[name])
    check(round(lines["detector_f1"]["value"], 3) == round(ref["native"]["detector_f1"], 3),
          lines["detector_f1"])
    for metric, name in (("e2e_synthetic_cer", "native"), ("e2e_synthetic_cer_devicecrop", "device"),
                         ("e2e_synthetic_cer_crop_scale2", "crop_scale_2"),
                         ("e2e_synthetic_cer_hostcrops", "classic")):
        check(abs(lines[metric]["value"] - ref[name]["e2e_cer"]) <= 0.005, (lines[metric], ref[name]))
    print(f"bench: {len(lines)} lines, primary first, all finite on {smi}; quality equal to "
          "configs/quality_reference.json within phase 7's tolerances")
    gate = subprocess_lines(["-m", "manuscript_tpu_torch.bench", "--perf-gate"], timeout=600)
    got = json.loads(next(ln for ln in gate.splitlines() if ln.startswith("PERF_GATE "))[10:])
    check(got["backend"] == "cuda" and got["device"] == smi and 0 < got["program_mfu"] <= 1.05, got)


def serve_bench_on_card() -> None:
    """Phase 12: the serving bench with ``.npy`` and PNG bodies, 8 clients,
    10 s each."""
    for codec in ("npy", "png"):
        out = subprocess_lines(["-m", "manuscript_tpu_torch.serve_bench", "--codec", codec,
                                "--clients", "8", "--seconds", "10"], timeout=600)
        rows = {r["metric"]: r for r in map(json.loads, (ln for ln in out.splitlines()
                                                          if ln.startswith("{")))}
        check(rows["serve_errors"]["value"] == 0 and rows["serve_pages_per_sec"]["value"] > 0, rows)


def decode_sweep(torch, k1, tmp: Path) -> None:
    """Phase 12: the decode sweep of ``examples/decode_sweep.py`` through K1:
    a ``Study`` over mode, beam size 2–12, alpha and temperature, sqlite
    storage, 8 trials on the micro TRBA checkpoint and 64 rendered crops;
    then ``sweep-report`` on its storage."""
    from manuscript_tpu_torch import TRBA
    from manuscript_tpu_torch.train.metrics import compute_accuracy
    from manuscript_tpu_torch.utils.sweep import Study
    from manuscript_tpu_torch.utils.synthetic import VOCAB, render_word

    torch.backends.cudnn.allow_tf32 = False
    model = TRBA(ROOT / "manuscript_tpu" / "configs" / "quality" / "trba_micro.msgpack", device="cuda")
    rng = np.random.default_rng(12)
    words = [str(VOCAB[int(i)]) for i in rng.integers(len(VOCAB), size=64)]
    crops = [render_word(w, rng) for w in words]
    trials = []

    def objective(params):
        before = k1.launches
        kw = {} if params["mode"] == "greedy" else dict(
            beam_size=params["beam_size"], alpha=params["alpha"], temperature=params["temperature"])
        got = model.predict(crops, batch_size=32, mode=params["mode"], **kw)
        acc = compute_accuracy(words, [r["text"] for r in got])
        trials.append((params, k1.launches - before, acc))
        return acc

    db = tmp / "decode_sweep.db"
    study = Study({"mode": ("cat", ["greedy", "beam"]), "beam_size": ("int", 2, 12),
                   "alpha": ("float", 0.0, 1.0), "temperature": ("float", 0.7, 2.0)},
                  storage=str(db), direction="maximize")
    best = study.optimize(objective, 8)
    for params, steps, acc in trials:
        print(f"   trial {params}: accuracy {acc:.4f}, K1 steps {steps}")
        # two batches of 32 crops: max_len beam steps, max_len + 1 greedy
        check(steps == 2 * (model.max_length + (params["mode"] == "greedy")), (params, steps))
    check(any(p["mode"] == "beam" for p, _, _ in trials), "no beam trial")
    html = tmp / "decode_sweep.html"
    out = subprocess_lines(["-m", "manuscript_tpu_torch", "sweep-report", str(db), "--out", str(html)],
                           timeout=300)
    page = html.read_text()
    check(f"best: value={best['value']:.6g}" in out and f"<td>{best['value']:.6g}</td>" in page
          and all(f"<td>{v}</td>" in page for v in best["params"].values()), best)
    print(f"best trial #{best['number']}: {best['params']} → {best['value']:.4f}; the report names it")


_CACHE_LOAD = (
    "import json; from manuscript_tpu_torch.utils.compile_cache import enable_compile_cache;"
    "from manuscript_tpu_torch.ops import _build; where = enable_compile_cache();"
    "seconds = _build.build(); libs = [_build.library(n)._name for n in _build.SOURCES];"
    "print(json.dumps({'cache': where, 'seconds': seconds, 'libs': libs}))"
)


def kernel_cache(tmp: Path) -> None:
    """Phase 12: every source built into ``MANUSCRIPT_TPU_KERNEL_CACHE`` by
    one process; a second, with no nvcc and no host compiler to be found,
    builds nothing and loads the cached libraries."""
    cache = tmp / "kernel_cache"
    env = dict(os.environ, MANUSCRIPT_TPU_KERNEL_CACHE=str(cache))
    first = json.loads(subprocess_lines(["-c", _CACHE_LOAD], timeout=600, env=env))
    check(first["cache"] == str(cache) and set(first["seconds"]) == {"attention_step", "quad_iou", "lanms"},
          first)
    check(all(Path(lib).parent == cache for lib in first["libs"]), first)
    empty = tmp / "empty"
    empty.mkdir()
    second = json.loads(subprocess_lines(["-c", _CACHE_LOAD], timeout=300,
                                         env=dict(env, PATH=str(empty), CUDA_HOME=str(empty))))
    check(second["seconds"] == {} and second["libs"] == first["libs"], second)
    print(f"kernel cache: the first process built {({k: round(v, 2) for k, v in first['seconds'].items()})} "
          f"s into it; the second, with no compiler on PATH, built {second['seconds']} and loaded "
          f"all {len(second['libs'])} libraries from it")


def measuring_tools(torch, k1, det, rec, rng) -> None:
    """Phase 12: the profiler split, the bench and its perf gate, the serving
    bench, the decode sweep through K1, and the kernel cache."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.perf_counter()
    profiler_split(torch, k1, det, rec, rng)
    print(f"(profiler part {time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()  # the bench's training steps run in a process of their own
    bench_on_card(smi)
    serve_bench_on_card()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        decode_sweep(torch, k1, Path(tmp))
        kernel_cache(Path(tmp))


def split_brightness(trba_batch, east_batch) -> tuple:
    """Phase 10's micro batches with their halves set apart: the uniform
    pixels of the first half of each batch mapped onto [0, 192), of the
    second onto [64, 256), so that statistics per rank differ from the
    global batch's (as in tests/test_torch_mesh_train.py)."""
    def split(x):
        x = x.astype(np.uint16) * 3 // 4
        x[len(x) // 2:] += 64
        return x.astype(np.uint8)

    return (split(trba_batch[0]), *trba_batch[1:]), (split(east_batch[0]), *east_batch[1:])


def _rank_micro_steps(mesh, east: bool = True, sync_bn: bool = True) -> list:
    """On each rank of ``mesh`` (``parallel.spawn``): phase 10's micro steps
    in float64 on the rank's slices of ``split_brightness``'s global
    batches, twice (the first warms cuDNN and the allocator) → rank 0's
    second. ``sync_bn=False`` keeps each rank's BatchNorm statistics its
    own (a wrong step)."""
    import torch
    from manuscript_tpu_torch.parallel import shard_batch

    global MICRO
    MICRO = micro_step_inputs()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.local_shards[0][1]
    pieces = [shard_batch(b, mesh)[0] for b in split_brightness(*MICRO[3:])]
    micro_steps(torch, dev, *pieces, mesh.group, east, torch.float64, sync_bn)
    return micro_steps(torch, dev, *pieces, mesh.group, east, torch.float64, sync_bn)


def micro_pages(mesh=None) -> list:
    """4 held-out pages through the micro checkpoints' pipeline, TF32 off,
    on ``mesh`` (2 pages a chunk) or on the card without one (1 a chunk) →
    every page's (text, polygon) pairs. Trained weights: unlike the random
    full-width ones, their beams have no ties, so texts must be equal."""
    import torch
    from manuscript_tpu_torch import Pipeline
    from manuscript_tpu_torch.utils.quality import load_quality_models
    from manuscript_tpu_torch.utils.synthetic import eval_pages

    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda" if mesh is None else str(mesh.local_shards[0][1])
    pipe = Pipeline(*load_quality_models(dev), device=dev, max_words=32,
                    batch_pages=1 if mesh is None else 2, mesh=mesh)
    return [[(w.text, w.polygon) for w in words_of(p)]
            for p in pipe.process_batch([p for p, _ in eval_pages(4, seed=9100)])]


def same_micro_pages(got, want, what: str) -> None:
    check([[t for t, _ in p] for p in got] == [[t for t, _ in p] for p in want], ("micro texts", what))
    box_d = max(np.abs(np.subtract(a, b)).max() for g, w in zip(got, want)
                for (_, a), (_, b) in zip(g, w))
    print(f"  micro checkpoints, {what}: {sum(len(p) for p in got)} words on {len(got)} pages, "
          f"texts equal to no mesh, max box |d| {box_d:.3e} px")
    check(box_d <= 1e-2, ("micro boxes", what, box_d))


def _rank_micro_pages(mesh) -> list:
    """On each rank of ``mesh``: ``micro_pages`` on the rank's mesh → rank
    0's and rank 1's."""
    import torch

    mine = micro_pages(mesh)
    theirs = [mine]
    torch.distributed.broadcast_object_list(theirs, src=1)
    return [mine, theirs[0]]


def _rank_full_pages(mesh, path: str) -> list:
    """On each rank of ``mesh`` (a process group): phase 3's full-width
    models, loaded from ``path`` with phase 5's pages and capacity, in a
    ``Pipeline(mesh=)`` whose ``process_batch`` of the 8 pages (4 a chunk, 2
    a rank) is timed after a warm-up, then ``micro_pages`` on the mesh →
    every rank's (pages, seconds, its own K1/K2 launches, micro pages),
    gathered."""
    import torch
    from manuscript_tpu_torch import Pipeline
    from manuscript_tpu_torch.ops import attention_step as k1, quad_iou as k2

    saved = torch.load(path, weights_only=False)
    det, rec = full_width_models(torch)
    det.model.load_state_dict(saved["det"])
    rec.model.load_state_dict(saved["rec"])
    det.score_thresh = saved["thresh"]
    pipe = Pipeline(det, rec, beam_size=8, batch_pages=4, max_words=saved["capacity"], mesh=mesh)
    pipe.process_batch(saved["pages"][:4])  # warm-up: cuDNN plans at these shapes
    torch.cuda.synchronize()
    torch.distributed.barrier()
    k1.launches = k2.launches = 0
    t0 = time.perf_counter()
    pages = pipe.process_batch(saved["pages"])
    torch.cuda.synchronize()
    mine = (pages, time.perf_counter() - t0, {"attention_step": k1.launches, "quad_iou": k2.launches},
            micro_pages(mesh))
    every = [None] * mesh.world_size
    torch.distributed.all_gather_object(every, mine)
    return every


def same_pages(got, want) -> None:
    """Pages of a mesh run against the run without: the same words, boxes
    within 1e-2 px, and the same texts but for ties of equal score (a word
    may read otherwise only when both confidences agree within 1e-6). The
    random weights' beams are full of such ties, and a shard's phase B may
    run at another slot count than the chunk of 2 pages without the mesh
    (the capacity bucket is the chunk's densest page's, as in the JAX
    package), so cuBLAS may sum in another order."""
    check([len(words_of(g)) for g in got] == [len(words_of(w)) for w in want],
          ([len(words_of(g)) for g in got], [len(words_of(w)) for w in want]))
    words = [(a, b) for g, w in zip(got, want) for a, b in zip(words_of(g), words_of(w))]
    box_d = max(np.abs(np.subtract(a.polygon, b.polygon)).max() for a, b in words)
    other = [(a.text, b.text, a.recognition_confidence, b.recognition_confidence)
             for a, b in words if a.text != b.text]
    print(f"  {len(words)} words on {len(got)} pages: max box |d| {box_d:.3e} px; other texts "
          f"{len(other)} {other[:3]}")
    check(box_d <= 1e-2, box_d)
    check(all(abs(c1 - c2) <= 1e-6 for *_, c1, c2 in other), other)


def mesh_inference(torch, det, rec, pages, capacity, k1, k2) -> dict:
    """Phase 13, inference: phase 5's 8 pages through ``process_batch`` with
    a mesh of two shards on the one card (4 pages a chunk, 2 a shard)
    against the same pages without a mesh at 2 a chunk (each shard's
    shapes), the capacity pinned at phase 5's; pages/s of both, and the
    kernels' launches around the mesh run (25 K1 steps and at least 2 K2
    launches per shard and chunk)."""
    from manuscript_tpu_torch import Pipeline
    from manuscript_tpu_torch.parallel import make_mesh

    kw = dict(beam_size=8, max_words=capacity)
    plain = Pipeline(det, rec, batch_pages=2, **kw)
    meshed = Pipeline(det, rec, batch_pages=4, mesh=make_mesh(devices=["cuda:0"] * 2), **kw)
    check(len(meshed._fused._replicas) == 2, "a copy of the models per shard")
    rates, outs = {}, {}
    for name, pipe in (("no mesh, 2 pages a chunk", plain), ("2 shards on cuda:0", meshed)):
        pipe.process_batch(pages[:4])  # warm-up: cuDNN plans at these shapes
        torch.cuda.synchronize()
        k1.launches = k1.kernel_launches = k2.launches = 0
        t0 = time.perf_counter()
        outs[name] = pipe.process_batch(pages)
        torch.cuda.synchronize()
        rates[name] = len(pages) / (time.perf_counter() - t0)
        launches = {"attention_step": k1.launches, "quad_iou": k2.launches}
        print(f"{name}: {rates[name]:.4f} pages/s; launches {launches} on "
              f"{len(pipe._fused.chunk_timings)} chunks, slots "
              f"{[c['slots'] for c in pipe._fused.chunk_timings]}")
    # the mesh run's: 2 chunks × 2 shards
    print(f"launches per shard and chunk, mesh run: {({k: v / 4 for k, v in launches.items()})}")
    check(launches["attention_step"] == 25 * 4 and launches["quad_iou"] >= 2 * 4, launches)
    same_pages(outs["2 shards on cuda:0"], outs["no mesh, 2 pages a chunk"])
    same_micro_pages(micro_pages(make_mesh(devices=["cuda:0"] * 2)), micro_pages(),
                     "2 shards on cuda:0")
    torch.backends.cudnn.allow_tf32 = True
    return {"rates": rates, "launches": launches, "want": outs["no mesh, 2 pages a chunk"]}


def mesh_group_pages(torch, det, rec, pages, capacity, want, tmp: Path) -> None:
    """Phase 13, inference under a process group: 2 gloo ranks on the one
    card (``_rank_full_pages``), each given phase 5's 8 pages, each
    returning every page, equal to the other rank's and, as ``same_pages``
    holds them, to the run without a mesh at 2 pages a chunk."""
    from manuscript_tpu_torch.parallel import make_mesh, spawn

    path = tmp / "full_width.pt"
    torch.save({"det": det.model.state_dict(), "rec": rec.model.state_dict(),
                "thresh": det.score_thresh, "pages": pages, "capacity": capacity}, path)
    t0 = time.perf_counter()
    ranks = spawn(_rank_full_pages, make_mesh(devices=["cuda:0"] * 2), str(path))
    print(f"Pipeline(mesh=).process_batch under 2 gloo ranks on cuda:0: started, ran and ended in "
          f"{time.perf_counter() - t0:.2f} s")
    micro_want = micro_pages()
    for rank, (got, seconds, launches, micro) in enumerate(ranks):
        print(f"  rank {rank}: {len(got)} pages in {seconds:.4f} s = {len(got) / seconds:.4f} "
              f"pages/s; its launches {launches}")
        check(launches["attention_step"] == 25 * 2 and launches["quad_iou"] >= 2 * 2, launches)
        same_pages(got, want)
        same_micro_pages(micro, micro_want, f"rank {rank} of 2 gloo ranks on cuda:0")
    first, second = ([[(w.text, w.polygon) for w in words_of(p)] for p in r[0]] for r in ranks)
    check(first == second, "every rank builds the same pages")
    print("  both ranks returned every page, the same pages")


def _trainer_runs(torch, name: str, fn, mesh) -> dict:
    """``fn(mesh)`` (a trainer's call) without a mesh and with ``mesh`` →
    each call's result and wall seconds, printed."""
    out = {}
    for what, m in (("no mesh", None), ("2 gloo ranks on cuda:0", mesh)):
        t0 = time.perf_counter()
        out[what] = fn(m)
        wall = time.perf_counter() - t0
        h = out[what]["history"]
        check(all(np.isfinite(e["train_loss"]) and np.isfinite(e["val_loss"]) for e in h), h)
        steps = sum(len(e["train_losses"]) for e in h)
        host = sum(e["host_s"] for e in h)
        print(f"{name}, {what}: wall {wall:.2f} s (with a mesh, the ranks' start included); "
              f"{steps} steps; "
              f"step losses {[v for e in h for v in e['train_losses']]}; host seconds per step "
              f"(rank 0's batch building) {host / steps:.4f}")
    return out


def mesh_trainers(torch, tmp: Path) -> None:
    """Phase 13, training through the entry points: ``TRBA.train`` and
    ``EAST.train`` with ``mesh=`` 2 gloo ranks on the one card (each call
    starts its ranks: spawn, the weights' broadcast, the ranks' own rows,
    the validation's gather, rank 0's writes) against the same call without
    a mesh, TF32 off on both sides (the ranks through
    ``NVIDIA_TF32_OVERRIDE=0``): every step loss and the validation loss
    within 1e-4 relative. TRBA at phase 10's shapes (256 crops of 64×256,
    batch 64, dropout on, drawn for the global batch; the host augmentation
    off, as its streams are per rank by design) for one epoch of 4 steps,
    with SGD (momentum 0.9, lr 1e-2): Adam's first steps move each entry by
    about ±lr whatever the size of its gradient, so float32 rounding of the
    near-zero entries (another batch size, other cuDNN kernels) flips their
    signs, and the validation loss parted by 5.3e-5 relative after 4 Adam
    steps in the first run of this comparison; EAST at phase 10's (resnet101, 1024², ASAM + SGD, OHEM,
    focal geometry, multiscale, freeze_first) on 8 pages at batch 4 (2 a
    rank) for one epoch of 2 steps, card-resident. Then EAST streamed from
    the host (its augmentation on), 1 rank against 2: rank 0's seconds of
    batch building per step."""
    from manuscript_tpu_torch import EAST, TRBA
    from manuscript_tpu_torch.parallel import make_mesh
    from manuscript_tpu_torch.utils.synthetic import build_page_dataset, build_word_dataset

    os.environ["NVIDIA_TF32_OVERRIDE"] = "0"
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(devices=["cuda:0"] * 2)
    tsv, imgs = build_word_dataset(tmp / "words", 256, seed=1)
    vtsv, vimgs = build_word_dataset(tmp / "val_words", 64, seed=2)
    cfg = dict(exp_root=str(tmp / "trba"), cnn_stage_plan="full", img_h=64, img_w=256,
               hidden_size=256, max_len=25, batch_size=64, lr=1e-2, optimizer="sgd",
               grad_clip=5.0, eval_beam=True, beam_size=8, epochs=1, seed=0,
               aug_params=dict(p_ShiftScaleRotate=0.0, p_BrightnessContrast=0.0))
    runs = _trainer_runs(torch, "TRBA.train full width", lambda m: TRBA.train(
        tsv, imgs, vtsv, vimgs, config=dict(cfg, exp_name="mesh" if m else "one"), mesh=m), mesh)
    coco, pages, _ = build_page_dataset(tmp / "pages", 8, seed=3)
    vcoco, vpages, _ = build_page_dataset(tmp / "val_pages", 4, seed=4)
    common = dict(experiment_root=str(tmp / "east"), target_size=1024, batch_size=4, epochs=1)
    east = _trainer_runs(torch, "EAST.train resnet101 at 1024², card-resident", lambda m: EAST.train(
        pages, coco, vpages, vcoco, model_name=f"dev{m is not None}", cache_device=True, mesh=m,
        **common), mesh)
    for name, got in (("TRBA", runs), ("EAST", east)):
        one, two = got["no mesh"], got["2 gloo ranks on cuda:0"]
        la = [v for e in one["history"] for v in e["train_losses"]]
        lb = [v for e in two["history"] for v in e["train_losses"]]
        va, vb = one["history"][-1]["val_loss"], two["history"][-1]["val_loss"]
        worst = max(abs(x - y) / abs(x) for x, y in zip(la + [va], lb + [vb]))
        print(f"{name}.train with 2 ranks vs without a mesh: validation loss {vb!r} vs {va!r}; "
              f"largest relative |d| of the step and validation losses {worst:.3e}")
        check(len(la) == len(lb) and worst <= 1e-4, (name, la, lb, va, vb))
    for k in ("no mesh", "2 gloo ranks on cuda:0"):
        check(runs[k]["history"][0]["beam"] is not None, "beam validation ran")
    _trainer_runs(torch, "EAST.train resnet101 at 1024², streamed from the host", lambda m: EAST.train(
        pages, coco, vpages, vcoco, model_name=f"host{m is not None}", mesh=m, **common), mesh)
    del os.environ["NVIDIA_TF32_OVERRIDE"]


def mesh_steps(torch) -> tuple:
    """Phase 13, the step: phase 10's micro steps on ``split_brightness``'s
    batches with 2 gloo ranks on the one card (NCCL refuses two ranks on one
    device) and with a 1-rank NCCL group, against the 1-rank step without a
    group on the same global batch, all in float64 and within
    ``FLOAT64_BOUND`` (TRBA: each leaf's gradient within 1e-8 of the leaf's
    largest entry plus 1e-10 of the largest of all, the loss within 1e-10
    relative; EAST, whose heads and loss compute in float32: 1e-6 and 1e-6;
    the running statistics within 1e-10); the seconds of each step (rank
    0's). The same 2 ranks with per-rank BatchNorm statistics must fail that
    bound. float64, as float32's two summation orders part by up to phase
    10's 1e-4 bound: on phase 10's crops one train-mode BatchNorm output
    before a ReLU lies within 4.2e-8 of its layer's largest from 0 on the
    card, and the ranks' sums in another order moved one entry of that
    channel's bias gradient by 1.2 % of the leaf's largest."""
    from manuscript_tpu_torch.parallel import make_mesh, spawn
    from manuscript_tpu_torch.utils.weights import params_from_jax

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    start = [{k: v.double() for k, v in params_from_jax(m).items()} for m in MICRO[:2]]
    batches = split_brightness(*MICRO[3:])
    micro_steps(torch, "cuda", *batches, dtype=torch.float64)  # warm-up
    one = micro_steps(torch, "cuda", *batches, dtype=torch.float64)
    for what, mesh, sync_bn in (("2 gloo ranks on cuda:0", make_mesh(devices=["cuda:0"] * 2), True),
                                ("1-rank NCCL group", make_mesh(devices=["cuda:0"]), True),
                                ("2 gloo ranks, per-rank BatchNorm (wrong)",
                                 make_mesh(devices=["cuda:0"] * 2), False)):
        t0 = time.perf_counter()
        ranks = spawn(_rank_micro_steps, mesh, True, sync_bn)
        print(f"{what}: started, stepped twice and ended in {time.perf_counter() - t0:.2f} s")
        for name, ref, got, st in zip(("TRBA", "EAST"), one, ranks, start):
            print(f"  {name} float64 step seconds: {got[3]:.4f} ({what}) vs {ref[3]:.4f} "
                  "(1 rank, no group)")
            gap = step_gap(torch, st, ref, got, FLOAT64_BOUND[name][0])
            if sync_bn:
                check_step(name, f"{what} vs 1 rank, float64", gap, ref[0], FLOAT64_BOUND[name])
            else:
                print(f"micro {name} train step, {what}: loss |d| {gap[0]:.3e}, gradients max |d| "
                      f"over the bound {gap[1]:.3e}, running statistics max |d| {gap[2]:.3e}: "
                      "outside the bound, as it must be")
                check(not within(gap, ref[0], FLOAT64_BOUND[name]), (name, what, gap))
    return one, start


def mesh_on_card(torch, det, rec, pages, capacity, k1, k2) -> dict:
    """Phase 13: ``make_mesh``'s one card and its refusal of more cards than
    there are, ``mesh_inference``, ``mesh_group_pages``, ``mesh_steps``,
    ``mesh_trainers``, and over two distinct cards with NCCL where the
    machine has them."""
    from manuscript_tpu_torch import Pipeline
    from manuscript_tpu_torch.parallel import make_mesh, spawn

    count = torch.cuda.device_count()
    print(f"device_count {count}")
    check(make_mesh(n_devices=1).shape == {"data": 1, "model": 1}, "make_mesh(n_devices=1)")
    try:
        make_mesh(n_devices=count + 1)
    except ValueError as e:
        print(f"make_mesh(n_devices={count + 1}) raises: {e}")
    else:
        check(False, f"make_mesh(n_devices={count + 1}) did not raise")
    result = mesh_inference(torch, det, rec, pages, capacity, k1, k2)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        mesh_group_pages(torch, det, rec, pages, capacity, result["want"], Path(tmp))
        one, start = mesh_steps(torch)
        mesh_trainers(torch, Path(tmp))
    if count < 2:
        print(f"not run: the multi-card part (process_batch over cards 0 and 1, the TRBA step and "
              f"the micro pages with 2 NCCL ranks), which needs 2 cards: this machine has {count}")
        return result
    torch.backends.cudnn.allow_tf32 = True
    cards = Pipeline(det, rec, beam_size=8, batch_pages=4, max_words=capacity,
                     mesh=make_mesh(n_devices=2))
    cards.process_batch(pages[:4])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = cards.process_batch(pages)
    torch.cuda.synchronize()
    rate = result["rates"]["2 shards on cards 0 and 1"] = len(pages) / (time.perf_counter() - t0)
    print(f"2 shards on cards 0 and 1: {rate:.4f} pages/s")
    same_pages(got, result["want"])
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    (trba,) = spawn(_rank_micro_steps, make_mesh(n_devices=2), False)
    print(f"  TRBA step seconds: {trba[3]:.4f} (2 NCCL ranks) vs {one[0][3]:.4f} (1 rank)")
    check_step("TRBA", "2 NCCL ranks on cards 0 and 1 vs 1 rank",
               step_gap(torch, start[0], one[0], trba, FLOAT64_BOUND["TRBA"][0]), one[0][0],
               FLOAT64_BOUND["TRBA"])
    ranks = spawn(_rank_micro_pages, make_mesh(n_devices=2))
    want = micro_pages()
    for rank, got in enumerate(ranks):
        same_micro_pages(got, want, f"rank {rank} of 2 NCCL ranks")
    print("2 NCCL ranks on cards 0 and 1: each rank returned every micro page, equal to one process")
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from manuscript_tpu_torch import EAST, TRBA, Pipeline
    from manuscript_tpu_torch.ops import _build, attention_step as k1, lanms_torch as k3, quad_iou as k2
    from manuscript_tpu_torch.ops.lanms_torch import _predecessor_pairs, locality_aware_nms_parallel

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)

    # ---- 1. build ----------------------------------------------------------
    phase("1 build")
    t0 = time.perf_counter()
    seconds = _build.build(verbose=True)
    print(f"build seconds, all sources at once: {time.perf_counter() - t0:.2f}; each (from the "
          f"common start to its compiler's end): {({k: round(v, 2) for k, v in seconds.items()})}")

    # ---- 2. kernels against their plain versions ---------------------------
    phase("2 kernels vs plain")
    print(smi)
    T, H, E, V, K = 32, 256, 256, 194, 8
    rn = lambda *s, sc=1.0: (torch.randn(*s, generator=gen) * sc).to(dev)
    r_max = 4096
    enc, proj = rn(r_max // K, T, E), rn(r_max // K, T, H)  # one row per word
    h, c = rn(r_max, H, sc=0.5), rn(r_max, H, sc=0.5)  # one row per beam
    tok = torch.randint(0, V, (r_max,), generator=gen, dtype=torch.int32).to(dev)
    w = (rn(H, H, sc=H**-0.5), rn(H, sc=0.1), rn(H, sc=H**-0.5),
         rn(E + V, 4 * H, sc=E**-0.5), rn(H, 4 * H, sc=H**-0.5), rn(4 * H, sc=0.1))
    k1_err, k1_rows = 0.0, {}
    # R = 8·nw for nw = 32 .. 256 slots of one page, and 8·B·nw for a chunk of
    # B pages (2048 and 4096 for 4 pages of 64 and 128 slots)
    for rows in (256, 512, 1024, 2048, 4096):
        words = rows // K
        a_ = (enc[:words], proj[:words], h[:rows], c[:rows], tok[:rows], *w)
        hk, ck = k1.attention_step_cuda(*a_, beam=K)
        hp, cp = k1.attention_step_plain(*a_, beam=K)
        torch.cuda.synchronize()
        err = max((hk - hp).abs().max().item(), (ck - cp).abs().max().item())
        check(err <= 1e-4, err)
        k1_err = max(k1_err, err)
        n_tok = int(torch.unique(a_[4]).numel())
        # the package's count (the bench's MFU uses the same): each input
        # read once, h' and c' written; memory read per beam row beside it
        flops, nbytes = k1.step_cost(words, rows, T, H, E, n_tok)
        nbytes_per_row = k1.step_cost(rows, rows, T, H, E, n_tok)[1]
        k1_rows[rows] = (graph_time_ms(torch, lambda: k1.attention_step_cuda(*a_, beam=K)),
                         graph_time_ms(torch, lambda: k1.attention_step_plain(*a_, beam=K)),
                         *bound(nbytes, flops), bound(nbytes_per_row, flops)[0])
        print(f"K1 attention_step R={rows} (B={words} words, beam {K}) T={T} H={H} E={E} V={V}: "
              f"max|dh|,|dc| = {err:.3e}; ms {{:.4f}} plain_ms {{:.4f}} bound_ms {{:.4f}} ({{}}); "
              "bound_ms counting the memory once per beam row {:.4f}".format(*k1_rows[rows]))
        grids = device_profile(torch, lambda: k1.attention_step_cuda(*a_, beam=K), calls=20)
        print("   its grids, device ms per step (spans overlap under programmatic launch): "
              + ", ".join(f"{name} {ms:.4f}" for name, (_, ms) in grids.items()))

    # K2 at the page path's sizes: 8191 predecessor pairs of 8192 candidates,
    # and compacted capacities 16·max_boxes = 4096 and 16384 with 10 % live;
    # each as one gathered launch and as torch gathers + the pairs kernel
    m_all = 8192
    q1n, q2n = test_quads(rng, m_all)
    quads = torch.from_numpy(np.stack([q1n, q2n], 1).reshape(2 * m_all, 4, 2)).to(dev)
    # quads 2j and 2j + 1 form a test pair: near-duplicate, identical, disjoint,
    # edge-touching or random
    k2_err, k2_rows, k2_ops = 0.0, {}, {}
    pred = quads[:m_all]
    pidx = torch.arange(m_all, dtype=torch.int32, device=dev)
    cases = [("pred", 8191, pred, pidx[1:], pidx[:-1], None,
              lambda: k2.quad_iou_pairs_cuda(pred[1:].contiguous(), pred[:-1].contiguous()))]
    for cap in (4096, 16384):
        mq = cap // 16
        j = torch.from_numpy(rng.integers(0, mq // 2, cap).astype(np.int32)).to(dev)
        ia, ib = 2 * j, 2 * j + 1
        pi, pj = ia.long(), ib.long()
        qs = quads[:mq]
        cases.append((f"cap{cap}", cap, qs, ia, ib,
                      torch.tensor(cap // 10, dtype=torch.int32, device=dev),
                      lambda qs=qs, pi=pi, pj=pj: k2.quad_iou_pairs_cuda(
                          qs[pi].contiguous(), qs[pj].contiguous())))
    # a chunk of 4 pages: the predecessor call over 4 × 8192 candidates, and
    # 4 pages of 16·256 compacted slots with per-page live counts (one page
    # full, one empty)
    quads4 = torch.cat([quads, quads + 2000.0])
    pa4, pb4 = _predecessor_pairs(4, m_all, dev)
    cases.append(("pred4", 4 * (m_all - 1), quads4, pa4, pb4, None,
                  lambda: k2.quad_iou_pairs_cuda(quads4[pa4.long()], quads4[pb4.long()])))
    j = torch.from_numpy(rng.integers(0, 128, 4 * 4096).astype(np.int32)).to(dev)
    base = torch.arange(4, dtype=torch.int32, device=dev).repeat_interleave(4096) * 256
    ia4, ib4 = base + 2 * j, base + 2 * j + 1
    qs4 = quads[: 4 * 256]
    live4 = torch.tensor([409, 4096, 0, 1500], dtype=torch.int32, device=dev)
    cases.append(("pages4", 4 * 4096, qs4, ia4, ib4, live4,
                  lambda: k2.quad_iou_pairs_cuda(qs4[ia4.long()], qs4[ib4.long()])))
    for name, pairs, qs, ia, ib, n_live, copy_form in cases:
        ik = k2.quad_iou_gather_cuda(qs, ia, ib, n_live)
        ip = k2.quad_iou_gather_plain(qs, ia, ib, n_live)
        q_a, q_b = qs[ia.long()], qs[ib.long()]
        ik1, ip1 = k2.quad_iou_pairs_cuda(q_a, q_b), k2.quad_iou_pairs_plain(q_a, q_b)
        torch.cuda.synchronize()
        err = max((ik - ip).abs().max().item(), (ik1 - ip1).abs().max().item())
        check(err <= 2e-5, err)
        k2_err = max(k2_err, err)
        live = pairs if n_live is None else int(n_live.sum())
        flops, nbytes = k2.gather_cost(qs.shape[0], pairs, live,
                                       0 if n_live is None else n_live.numel())
        k2_rows[name] = (graph_time_ms(torch, lambda: k2.quad_iou_gather_cuda(qs, ia, ib, n_live)),
                         graph_time_ms(torch, lambda: k2.quad_iou_gather_plain(qs, ia, ib, n_live)),
                         *bound(nbytes, flops), graph_time_ms(torch, copy_form))
        k2_ops[name] = (device_ops(torch, lambda: k2.quad_iou_gather_cuda(qs, ia, ib, n_live)),
                        device_ops(torch, copy_form))
        print(f"K2 quad_iou_gather {name}: P={pairs} pairs of {qs.shape[0]} quads, {live} live: "
              f"max|d| = {err:.3e}; IoU>0 share {(ip[ip != 0].numel() / max(live, 1)):.3f}; "
              "ms {:.4f} plain_ms {:.4f} bound_ms {:.4f} ({}); as gathers "
              "(torch gathers + quad_iou_pairs) ms {:.4f}".format(*k2_rows[name])
              + f"; device ops per call {k2_ops[name][0]} vs as gathers {k2_ops[name][1]}")

    a, b = q1n[:1024], q2n[:1024]
    a, b = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    mk, mp = k2.quad_iou_matrix_cuda(a, b), k2.quad_iou_matrix_plain(a, b)
    torch.cuda.synchronize()
    k2m_err = (mk - mp).abs().max().item()
    check(k2m_err <= 2e-5, k2m_err)
    k2m = (graph_time_ms(torch, lambda: k2.quad_iou_matrix_cuda(a, b)),
           graph_time_ms(torch, lambda: k2.quad_iou_matrix_plain(a, b), calls=2, replays=3),
           *bound(k2.matrix_cost(1024, 1024)[1], k2.matrix_cost(1024, 1024)[0]))
    print(f"K2 quad_iou_matrix 1024x1024: max|d| = {k2m_err:.3e}; "
          "ms {:.4f} plain_ms {:.4f} bound_ms {:.4f} ({})".format(*k2m))

    scores = torch.from_numpy(rng.uniform(0.5, 1, (m_all, 1)).astype(np.float32)).to(dev)
    cands = torch.cat([quads[:m_all].reshape(m_all, 8), scores], 1)
    nms_ops = device_ops(torch, lambda: locality_aware_nms_parallel(cands, 0.2, max_out=256))
    print(f"device ops of one locality_aware_nms_parallel call (8192 candidates, "
          f"256 boxes): {nms_ops}")
    k3_rows_ = k3_rows(torch, k3, rng, dev)

    # ---- 3. full width, random init ----------------------------------------
    phase("3 full width, random weights")
    det, rec = full_width_models(torch)
    first_pass_cost(torch, rec)
    pipe = Pipeline(det, rec, beam_size=8)
    pages = [synthetic_page(rng) for _ in range(4)]
    word_sized_boxes(torch, det, pages[0])
    pipe.predict(pages[0])  # warm-up: cuDNN plans, word capacity
    torch.cuda.synchronize()
    k1.launches = k1.kernel_launches = k2.launches = 0
    latencies, results, stages = [], [], []
    for page in pages[1:]:
        t0 = time.perf_counter()
        results.append(pipe.predict(page))
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        stages.append({k: round(v, 4) for k, v in pipe._fused.last_timings.items()})
    launches = {"attention_step": k1.launches, "quad_iou": k2.launches}
    slots = [int(st["slots"]) for st in stages]
    words = [w for p in results for w in words_of(p)]
    n_text = sum(w.text is not None for w in words)
    print(f"page latency s: {[round(x, 4) for x in latencies]} "
          f"(mean {statistics.mean(latencies):.4f}); boxes {len(words)}, "
          f"recognized words {n_text}; word capacity {pipe._fused.max_words}, "
          f"max_boxes {det.max_boxes}; score_thresh {det.score_thresh:.4f}; "
          f"launches {launches}")
    print(f"stage seconds per page: {stages}")
    print(f"slots per page (nw): {slots}, so K1 ran at R = 8·nw = {[8 * n for n in slots]} "
          f"beam rows; K1 steps {k1.launches} ({k1.kernel_launches} kernel launches), "
          f"K2 launches {k2.launches}, on {len(latencies)} pages")
    # 25 decode steps per page; both NMS calls of each page's phase A (more
    # when the word capacity grows and phase A runs again)
    check(launches["attention_step"] == 25 * len(latencies), launches)
    check(launches["quad_iou"] >= 2 * len(latencies), launches)
    check_finite(words)

    strip = np.stack([
        np.full((64, 256, 3), int(v), np.uint8) for v in rng.integers(0, 256, 32)
    ])
    strip[:, 20:44, 10:200] = 0
    before = k1.launches
    confs, preds = pipe._fused.recognize(strip)
    check(k1.launches - before == 25, k1.launches - before)
    check(preds.shape == (32, 25) and np.all(np.isfinite(confs)), (preds.shape, confs))
    print(f"fixed strip: 32 crops → {k1.launches - before} K1 launches at R=256; "
          f"confidences {np.round(confs[:4], 4).tolist()}...")

    # ---- 4. trained micro weights, card vs CPU ------------------------------
    phase("4 micro checkpoints, card vs CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    qdir = ROOT / "manuscript_tpu" / "configs" / "quality"
    meta = json.loads((qdir / "east_micro.json").read_text())
    clean = np.load(ROOT / "manuscript_tpu_torch" / "configs" / "synthetic_page.npz")["page"]
    noisy = clean[..., None].astype(np.float32) + np.random.default_rng(5).normal(0, 3, (*clean.shape, 3))
    page = np.clip(noisy, 0, 255).astype(np.uint8)
    out = {}
    for device in ("cuda", "cpu"):
        d = EAST(qdir / "east_micro.msgpack", device=device, backbone=meta["backbone"],
                 target_size=meta["target_size"], score_thresh=meta["score_thresh"],
                 expand_ratio_w=meta["expand_ratio"], expand_ratio_h=meta["expand_ratio"],
                 quantization=meta["quantization"], max_candidates=2048, max_boxes=256,
                 dtype=torch.float32)
        r = TRBA(qdir / "trba_micro.msgpack", device=device)
        p = Pipeline(d, r, device=device, max_words=32).predict(page)
        out[device] = [w for blk in p.blocks for w in blk.words]
    gw, cw = out["cuda"], out["cpu"]
    check(len(gw) == len(cw) and len(gw) > 0, (len(gw), len(cw)))
    box_err = max(np.abs(np.subtract(a.polygon, b.polygon)).max() for a, b in zip(gw, cw))
    texts = [w.text for w in gw]
    print(f"{len(gw)} words; max box |d| card vs CPU {box_err:.3e} px; texts {texts}")
    check(texts == [w.text for w in cw], [w.text for w in cw])
    check(box_err <= 1e-2, box_err)

    # ---- 5. many pages, full width -------------------------------------------
    phase("5 many pages, full width, random weights")
    torch.backends.cudnn.allow_tf32 = True  # torch's default, as phase 3 ran
    batch_launches, chunks, fused_rates, pages5, capacity5 = many_pages(torch, det, rec, rng, k1, k2)

    # ---- 6. micro checkpoints: process_batch against predict on the card ------
    phase("6 micro checkpoints, process_batch vs predict and calibrate, card vs CPU")
    torch.backends.cudnn.allow_tf32 = False
    micro_batches(torch)

    # ---- 7. the quality harness on the card -------------------------------------
    phase("7 quality harness on the card")
    quality_on_card()

    # ---- 8. the classic host path --------------------------------------------------
    phase("8 classic host path, full width, random weights; micro checkpoints card vs CPU")
    torch.backends.cudnn.allow_tf32 = True
    classic_launches = classic_path(torch, det, rec, rng, k1, k2, k3, fused_rates)
    torch.backends.cudnn.allow_tf32 = False
    classic_micro(torch)

    # ---- 9. serving ------------------------------------------------------------------
    phase("9 serving")
    serving(torch, det, rec, rng, k1, k2)

    # ---- 10. training ----------------------------------------------------------------
    phase("10 training")
    print(smi)
    train_launches = training(torch, k1)

    # ---- 11. reference weights, TPS, vis -----------------------------------------------
    phase("11 reference weights, TPS, vis")
    print(smi)
    ref_launches = reference_weights_tps_vis(torch, rng, k1, k2)

    # ---- 12. measuring tools ---------------------------------------------------------------
    phase("12 measuring tools: profiler, bench, perf gate, serving bench, decode sweep, kernel cache")
    print(smi)
    measuring_tools(torch, k1, det, rec, rng)

    # ---- 13. the mesh ---------------------------------------------------------------------
    phase("13 mesh on the card")
    print(smi)
    # torch's defaults (phase 11 turned matmul TF32 on), which the ranks that
    # phase 13 spawns start with: their pages are held to this process's
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    mesh_result = mesh_on_card(torch, det, rec, pages5, capacity5, k1, k2)

    # ---- result ---------------------------------------------------------------
    phase("result")
    print(smi)
    # the rows of the batched path: K1 at its largest beam-row count (8·B·nw
    # of the densest chunk), K2 at the chunk's predecessor call, the larger
    # of its two NMS calls
    r_batch = 8 * max(c["pages"] * c["slots"] for c in chunks)
    r_row = min((r for r in k1_rows if r >= r_batch), default=max(k1_rows))
    k1_ms, k1_plain_ms, k1_bound, k1_by, _ = k1_rows[r_row]
    k2_ms, k2_plain_ms, k2_bound, k2_by, _ = k2_rows["pred4"]
    k3_ms, k3_plain_ms, k3_bound, k3_by, _ = k3_rows_[8192]
    print(f"kernel rows: K1 and K2 launches of process_batch on 8 pages (phase 5; "
          f"Pipeline.predict on 3 pages in phase 3: {launches}; training's validations in "
          f"phase 10: {train_launches} K1 steps; phase 11: {ref_launches}; phase 13, two shards "
          f"on one card: {mesh_result['launches']}), K3 launches of "
          f"EAST(nms='device').predict on 3 pages (phase 8); K1 at R={r_row}, K2 gathered at "
          f"4 × 8191 predecessor pairs, K3 at 8192 candidates")
    rows = [
        {"name": "attention_step", "route": "cuda",
         "source": "manuscript_tpu_torch/csrc/attention_step.cu",
         "replaces": "manuscript_tpu/ops/pallas_attention.py:116",
         "launches": batch_launches["attention_step"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "quad_iou", "route": "cuda",
         "source": "manuscript_tpu_torch/csrc/quad_iou.cu",
         "replaces": "manuscript_tpu/ops/pallas_iou.py:136",
         "launches": batch_launches["quad_iou"], "max_abs_err": max(k2_err, k2m_err),
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
        {"name": "lanms_merge_scan", "route": "cuda",
         "source": "manuscript_tpu_torch/csrc/quad_iou.cu",
         "replaces": "manuscript_tpu/ops/lanms_jax.py:151 (the lax.scan merge of "
                     "locality_aware_nms_jax; XLA, not Pallas: a kernel of the port only)",
         "launches": classic_launches["lanms_merge_scan"],
         "max_abs_err": max(r[-1] for r in k3_rows_.values()),
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": None},
    ]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
