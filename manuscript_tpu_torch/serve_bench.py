"""HTTP serving benchmark of the port (counterpart of
``examples/serve_bench.py``): sustained requests/s and latency percentiles
through the whole serving stack on one card — HTTP parse → body decode →
bounded queue → micro-batcher → ``start_batch``/``finish_batch`` → JSON.

Codec (``--codec``):

* ``npy`` — raw ``np.save`` bytes: no host decode, the serving ceiling the
  card and the pipeline set;
* ``png`` / ``jpeg`` — what a browser-facing deployment sends: adds the
  per-request PIL decode (PIL is imported only for these).

Closed loop: ``--clients`` threads each POST the bench's page
(``bench.build_page``, random weights calibrated as the bench does) back to
back for ``--seconds``. Prints one JSON line per metric in the bench's
shape: requests/s, pages/s, p50/p90/p99 latency, the mean batch fill from
``/metrics`` and the failed requests, each with the card's name; exits
non-zero when a request failed.

Usage::

    python -m manuscript_tpu_torch.serve_bench                  # npy, 8 clients
    python -m manuscript_tpu_torch.serve_bench --codec png --clients 4
    MANUSCRIPT_TPU_BENCH_SMOKE=1 python -m manuscript_tpu_torch.serve_bench  # CPU self-test
"""

from __future__ import annotations

import argparse
import io
import statistics

import numpy as np


def encode_body(page: np.ndarray, codec: str) -> bytes:
    if codec == "npy":
        from .bench import npy_body

        return npy_body(page)
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(page).save(buf, format=codec.upper())
    return buf.getvalue()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--codec", choices=("npy", "jpeg", "png"), default="npy")
    ap.add_argument("--mode", choices=("beam", "greedy"), default="beam")
    ap.add_argument("--batch-pages", type=int, default=4)
    ap.add_argument("--batch-wait-ms", type=float, default=25.0)
    args = ap.parse_args(argv)

    from .bench import Emitter, calibrate, card_name, closed_loop, is_smoke, models
    from .pipeline import Pipeline
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache(None)
    smoke = is_smoke()
    if smoke:
        args.seconds, args.clients = min(args.seconds, 4.0), min(args.clients, 3)
    dev, east, trba, pages = models(smoke)
    emit = Emitter(card_name(dev), smoke)
    pipe = Pipeline(detector=east, recognizer=trba, device=dev, mode=args.mode,
                    batch_pages=args.batch_pages, max_words=16 if smoke else "auto")
    page = pages[0]
    thresh, _ = calibrate(pipe._fused, page)
    emit("serve_calibrated_thresh", thresh, "score_thresh")
    # the first passes at each shape (cuDNN plans, the allocator) before the window
    pipe.predict(page)
    pipe.process_batch([page] * args.batch_pages)

    body = encode_body(page, args.codec)
    emit("serve_request_body_bytes", len(body), "bytes", codec=args.codec)
    lat, failed, elapsed, fill = closed_loop(pipe, body, args.batch_pages, args.clients,
                                             args.seconds, args.batch_wait_ms)
    n = len(lat)
    common = dict(codec=args.codec, clients=args.clients, mode=args.mode)
    emit("serve_requests_per_sec", (n + len(failed)) / elapsed, "requests/s", **common)
    if n:
        lat = sorted(lat)
        emit("serve_pages_per_sec", n / elapsed, "pages/s", errors=len(failed),
             mean_batch_fill=round(fill, 3), **common)
        emit("serve_latency_p50_s", statistics.median(lat), "s", n=n, codec=args.codec)
        emit("serve_latency_p90_s", lat[int(0.90 * (n - 1))], "s", n=n, codec=args.codec)
        emit("serve_latency_p99_s", lat[int(0.99 * (n - 1))], "s", n=n, codec=args.codec)
    emit("serve_errors", len(failed), "requests", attempted=n + len(failed), codec=args.codec)
    if failed or not n:
        raise SystemExit(f"serve_bench: {len(failed)} of {n + len(failed)} requests failed: "
                         f"{failed[:3]}")


if __name__ == "__main__":
    main()
