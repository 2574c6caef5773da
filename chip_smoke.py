#!/usr/bin/env python3
"""Smoke run of manuscript_tpu_torch on one CUDA card.

    python3 chip_smoke.py

from the root of a checkout. Phases, each checking; a failed phase ends the
run with a traceback and a non-zero exit:

1. build the CUDA kernels of manuscript_tpu_torch/csrc with nvcc
   (into build/kernels/) and print the build seconds;
2. hold each kernel against its plain torch version at the main path's
   shapes, and time both (CUDA events over a CUDA graph of repeated calls,
   median of several replays, after warm-up): K1 at R = 256..2048 beam rows
   (beam 8), K2's gathered entry at the NMS's sizes beside the same call
   made of torch gathers and the pairs kernel, and the matrix entry at
   1024×1024;
3. full width with random weights from a seed: EAST resnet50 at 1280² (q=2,
   8192 candidates, 1024 boxes, bf16) and TRBA full (64×256, hidden 256,
   194 tokens, beam 8, max_len 25) through ``Pipeline.predict`` on 3 pages,
   with the kernels' launch counts read around exactly that run (25 K1
   steps per page, K2 in both NMS calls) and each page's word slots; then
   the recognizer on a fixed 32-crop strip (256 beam rows);
4. the committed micro checkpoints (manuscript_tpu/configs/quality/) on one
   synthetic page, on the card and on the CPU: equal texts, boxes within
   1e-2 px.

It prints the card's name and power limit, one JSON line with a row per
kernel, and last the line ``{"ok": true, "device": {...}}``. Without a CUDA
card, or without the rest of the repository beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores


def check(ok, what) -> None:
    """A phase's assertion (kept under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase(name: str) -> None:
    print(f"\n=== {name} ===", flush=True)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from manuscript_tpu_torch import EAST, TRBA, Pipeline
    from manuscript_tpu_torch.ops import _build, attention_step as k1, quad_iou as k2
    from manuscript_tpu_torch.ops.image import detector_preprocess_host
    from manuscript_tpu_torch.ops.lanms_torch import locality_aware_nms_parallel

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)

    # ---- 1. build ----------------------------------------------------------
    phase("1 build")
    t_build = _build.build(verbose=True)
    print(f"build seconds: {t_build:.2f}")

    # ---- 2. kernels against their plain versions ---------------------------
    phase("2 kernels vs plain")
    print(smi)
    T, H, E, V, K = 32, 256, 256, 194, 8
    rn = lambda *s, sc=1.0: (torch.randn(*s, generator=gen) * sc).to(dev)
    r_max = 2048
    enc, proj = rn(r_max // K, T, E), rn(r_max // K, T, H)  # one row per word
    h, c = rn(r_max, H, sc=0.5), rn(r_max, H, sc=0.5)  # one row per beam
    tok = torch.randint(0, V, (r_max,), generator=gen, dtype=torch.int32).to(dev)
    w = (rn(H, H, sc=H**-0.5), rn(H, sc=0.1), rn(H, sc=H**-0.5),
         rn(E + V, 4 * H, sc=E**-0.5), rn(H, 4 * H, sc=H**-0.5), rn(4 * H, sc=0.1))
    k1_err, k1_rows = 0.0, {}
    for rows in (256, 512, 1024, 2048):  # R = 8·nw for nw = 32, 64, 128, 256
        words = rows // K
        a_ = (enc[:words], proj[:words], h[:rows], c[:rows], tok[:rows], *w)
        hk, ck = k1.attention_step_cuda(*a_, beam=K)
        hp, cp = k1.attention_step_plain(*a_, beam=K)
        torch.cuda.synchronize()
        err = max((hk - hp).abs().max().item(), (ck - cp).abs().max().item())
        check(err <= 1e-4, err)
        k1_err = max(k1_err, err)
        n_tok = int(torch.unique(a_[4]).numel())
        # each input read once: the words' memory, h, c, tok, W_h2h, b_h2h,
        # w_score, W_ih[:E], the token rows used, W_hh, bias; h', c' written
        rest = 2 * rows * H + rows + H * H + 2 * H + (E + n_tok + H) * 4 * H + 4 * H + 2 * rows * H
        nbytes = 4 * (words * T * (E + H) + rest)
        nbytes_per_row = 4 * (rows * T * (E + H) + rest)  # memory read per beam row
        flops = rows * (2 * H * H + 3 * T * H + 5 * T + 2 * T * E + 8 * E * H
                        + 8 * H * H + 16 * H)
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
    for name, pairs, qs, ia, ib, n_live, copy_form in cases:
        ik = k2.quad_iou_gather_cuda(qs, ia, ib, n_live)
        ip = k2.quad_iou_gather_plain(qs, ia, ib, n_live)
        q_a, q_b = qs[ia.long()], qs[ib.long()]
        ik1, ip1 = k2.quad_iou_pairs_cuda(q_a, q_b), k2.quad_iou_pairs_plain(q_a, q_b)
        torch.cuda.synchronize()
        err = max((ik - ip).abs().max().item(), (ik1 - ip1).abs().max().item())
        check(err <= 2e-5, err)
        k2_err = max(k2_err, err)
        live = pairs if n_live is None else int(n_live)
        nbytes = qs.numel() * 4 + pairs * (4 + 4 + 4) + (0 if n_live is None else 4)
        k2_rows[name] = (graph_time_ms(torch, lambda: k2.quad_iou_gather_cuda(qs, ia, ib, n_live)),
                         graph_time_ms(torch, lambda: k2.quad_iou_gather_plain(qs, ia, ib, n_live)),
                         *bound(nbytes, live * 860), graph_time_ms(torch, copy_form))
        k2_ops[name] = (device_ops(torch, lambda: k2.quad_iou_gather_cuda(qs, ia, ib, n_live)),
                        device_ops(torch, copy_form))
        print(f"K2 quad_iou_gather {name}: P={pairs} pairs of {qs.shape[0]} quads, {live} live: "
              f"max|d| = {err:.3e}; IoU>0 share {(ip[:live] > 0).float().mean().item():.3f}; "
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
           *bound(2048 * 32 + 1024 * 1024 * 4, 1024 * 1024 * 860))
    print(f"K2 quad_iou_matrix 1024x1024: max|d| = {k2m_err:.3e}; "
          "ms {:.4f} plain_ms {:.4f} bound_ms {:.4f} ({})".format(*k2m))

    scores = torch.from_numpy(rng.uniform(0.5, 1, (m_all, 1)).astype(np.float32)).to(dev)
    cands = torch.cat([quads[:m_all].reshape(m_all, 8), scores], 1)
    nms_ops = device_ops(torch, lambda: locality_aware_nms_parallel(cands, 0.2, max_out=256))
    print(f"device ops of one locality_aware_nms_parallel call (8192 candidates, "
          f"256 boxes): {nms_ops}")

    # ---- 3. full width, random init ----------------------------------------
    phase("3 full width, random weights")
    det = EAST(backbone="resnet50", target_size=1280, quantization=2,
               max_candidates=8192, max_boxes=1024, dtype=torch.bfloat16,
               allow_random_init=True, seed=0)
    rec = TRBA(cnn_stage_plan="full", img_h=64, img_w=256, hidden_size=256,
               max_length=25, allow_random_init=True, seed=1)
    pipe = Pipeline(det, rec, beam_size=8)
    pages = [synthetic_page(rng) for _ in range(4)]
    # random weights give sub-pixel geometry and scores near 0.4: set the
    # geometry bias to a word-sized quad (24×8 map px) and the threshold to
    # the 99.5th percentile of the first page's score map, so phase A emits
    # word boxes and phase B recognizes them
    with torch.no_grad():
        det.model.geo_head.bias.copy_(torch.tensor([-12.0, -4, 12, -4, 12, 4, -12, 4]))
        x = torch.from_numpy(detector_preprocess_host(pages[0], det.target_size)).to(dev)
        score = det.model(((x.to(det.dtype) / 255.0 - 0.5) / 0.5)[None])["score"]
        det.score_thresh = float(torch.quantile(score.flatten().float(), 0.995))
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
    words = [w for p in results for blk in p.blocks for w in blk.words]
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
    for w_ in words:
        check(np.all(np.isfinite(w_.polygon)) and np.isfinite(w_.detection_confidence), w_)
        check(w_.recognition_confidence is None or np.isfinite(w_.recognition_confidence), w_)

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

    # ---- result ---------------------------------------------------------------
    print(smi)
    # K1's row at the beam-row count the pages ran (the largest), K2's at the
    # predecessor call, the larger of the two NMS calls
    r_page = min((r for r in k1_rows if r >= 8 * max(slots)), default=max(k1_rows))
    k1_ms, k1_plain_ms, k1_bound, k1_by, _ = k1_rows[r_page]
    k2_ms, k2_plain_ms, k2_bound, k2_by, _ = k2_rows["pred"]
    print(f"kernel rows: K1 at R={r_page}, K2 gathered at 8191 predecessor pairs")
    rows = [
        {"name": "attention_step", "route": "cuda",
         "source": "manuscript_tpu_torch/csrc/attention_step.cu",
         "replaces": "manuscript_tpu/ops/pallas_attention.py:116",
         "launches": launches["attention_step"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "quad_iou", "route": "cuda",
         "source": "manuscript_tpu_torch/csrc/quad_iou.cu",
         "replaces": "manuscript_tpu/ops/pallas_iou.py:136",
         "launches": launches["quad_iou"], "max_abs_err": max(k2_err, k2m_err),
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
    ]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
