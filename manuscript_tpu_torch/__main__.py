"""Command line of the port (counterpart of ``manuscript_tpu/__main__.py``),
on the card:

    python -m manuscript_tpu_torch ocr page.jpg [more.jpg ...] [--out result.json] [--vis page.png] [--n-devices 2]
    python -m manuscript_tpu_torch detect page.jpg [--thresh 0.6] [--out boxes.json] [--vis boxes.png]
    python -m manuscript_tpu_torch recognize crop1.png crop2.png [--mode greedy]
    python -m manuscript_tpu_torch serve [--port 8000] [--n-devices 2]
    python -m manuscript_tpu_torch bench
    python -m manuscript_tpu_torch sweep-report study.db [--out report.html]

Weights come from ``--weights``, else ``~/.manuscript_tpu/{east,trba}``, else
the reference's release fetched there on first use; with none of these,
``MANUSCRIPT_TPU_ALLOW_RANDOM_INIT=1`` allows untrained ones. ``--vis``
writes the page drawn with its words (PIL; the format from the file name).
``bench`` runs ``manuscript_tpu_torch/bench.py`` (``MANUSCRIPT_TPU_BENCH_SMOKE=1``
runs it on the CPU at tiny shapes). ``MANUSCRIPT_TPU_KERNEL_CACHE`` names a
persistent directory for the built kernels (``utils/compile_cache.py``).
``--n-devices N`` (N > 1) shards the pages of ``ocr`` and ``serve`` over a
mesh of the first N cards (``parallel.make_mesh``).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def _max_words(value: str):
    return value if value == "auto" else int(value)


def _write_json(path, obj) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, ensure_ascii=False, indent=1)


def _out_path(out: str, image: str, images) -> str:
    """One output file per page of a multi-page run: ``<out stem>.<image
    stem><out suffix>``, with the input's index added when two inputs share
    a stem."""
    out_path, stem = Path(out), Path(image).stem
    if sum(1 for im in images if Path(im).stem == stem) > 1:
        stem = f"{stem}.{images.index(image)}"
    return str(out_path.with_name(f"{out_path.stem}.{stem}{out_path.suffix}"))


def _mesh_from_args(args):
    """A data mesh over the first ``--n-devices`` cards when N > 1, else
    None."""
    if args.n_devices > 1:
        from .parallel import make_mesh

        return make_mesh(args.n_devices)
    return None


def cmd_ocr(args):
    from . import Pipeline

    pipe = Pipeline(
        mode=args.mode, batch_pages=args.batch_pages, max_words=args.max_words,
        crop_scale=args.crop_scale, crop_source=args.crop_source, mesh=_mesh_from_args(args),
    )
    if len(args.images) > 1 and not args.vis:
        # many pages ride process_batch: batch_pages pages per device pass
        t0 = time.time()
        pages = pipe.process_batch(list(args.images), profile=args.profile)
        dt = time.time() - t0
        for image, page in zip(args.images, pages):
            result = {"image": image, "seconds": round(dt / len(args.images), 3),
                      "text": pipe.get_text(page), "page": page.model_dump()}
            if args.out:
                out = _out_path(args.out, image, args.images)
                _write_json(out, result)
                print(f"{image}: → {out}")
            else:
                print(result["text"])
        return
    for image in args.images:
        t0 = time.time()
        if args.vis:
            page, vis_img = pipe.predict(image, vis=True, profile=args.profile)
            vis_img.save(args.vis)
        else:
            page = pipe.predict(image, profile=args.profile)
        result = {"image": image, "seconds": round(time.time() - t0, 3),
                  "text": pipe.get_text(page), "page": page.model_dump()}
        if args.out:
            _write_json(args.out, result)
            print(f"{image}: {result['seconds']}s → {args.out}")
        else:
            print(result["text"])


def cmd_detect(args):
    from .detectors import EAST

    det = EAST(weights_path=args.weights, target_size=args.target_size, score_thresh=args.thresh)
    for image in args.images:
        res = det.predict(image, vis=bool(args.vis), profile=args.profile)
        print(f"{image}: {sum(len(b.words) for b in res['page'].blocks)} words")
        if args.vis and res["vis_image"] is not None:
            res["vis_image"].save(args.vis)
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                json.dump(res["page"].model_dump(), f, ensure_ascii=False)


def cmd_recognize(args):
    from .recognizers import TRBA

    rec = TRBA(model_path=args.weights)
    results = rec.predict(
        list(args.images), batch_size=args.batch_size, mode=args.mode, beam_size=args.beam_size
    )
    for path, r in zip(args.images, results):
        print(f"{path}\t{r['text']}\t{r['confidence']:.4f}")


def cmd_bench(args):
    from . import bench

    bench.main()


def cmd_sweep_report(args):
    from .utils.sweep import sweep_report

    print(sweep_report(args.storage, out_html=args.out))


def cmd_serve(args):
    from . import Pipeline
    from .serve import OCRServer

    pipe = Pipeline(
        mode=args.mode, batch_pages=args.batch_pages, max_words=args.max_words,
        crop_source=args.crop_source, mesh=_mesh_from_args(args),
    )
    server = OCRServer(
        pipe, host=args.host, port=args.port, batch_wait_ms=args.batch_wait_ms,
        max_queue=args.max_queue, request_timeout_s=args.request_timeout_s,
    )
    print(
        f"serving OCR on http://{args.host}:{server.port} (micro-batch {server.batch_pages} "
        f"pages, wait {args.batch_wait_ms} ms) — POST /ocr, GET /healthz, /metrics",
        flush=True,
    )
    server.serve_forever()


def main(argv=None):
    # a host that sets MANUSCRIPT_TPU_KERNEL_CACHE starts every entry point
    # with the kernels it built before
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache(None)

    parser = argparse.ArgumentParser(prog="manuscript_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("ocr", help="full-page OCR")
    p.add_argument("images", nargs="+")
    p.add_argument("--out", help="write JSON result")
    p.add_argument("--vis", help="write visualization PNG")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--mode", choices=["beam", "greedy"], default="beam")
    p.add_argument("--batch-pages", type=int, default=4,
                   help="pages per device pass in multi-image runs")
    p.add_argument("--max-words", default="auto", type=_max_words,
                   help="recognition capacity per page on the fused path; 'auto' "
                        "(default) sizes it to the first page")
    p.add_argument("--crop-scale", type=int, default=1,
                   help="k>1 crops from a (k*target)^2 page copy on the device "
                        "(implies --crop-source device)")
    p.add_argument("--crop-source", choices=["native", "device"], default="native",
                   help="'native' (default): crops from the full-resolution page on the "
                        "host; 'device': crops gathered on the device from the "
                        "detector's copy")
    p.add_argument("--n-devices", type=int, default=1,
                   help="shard the pages over an N-card data mesh; --batch-pages rounds up "
                        "to a multiple of N")
    p.set_defaults(func=cmd_ocr)

    p = sub.add_parser("detect", help="text detection only")
    p.add_argument("images", nargs="+")
    p.add_argument("--weights")
    p.add_argument("--thresh", type=float, default=0.6)
    p.add_argument("--target-size", type=int, default=1280)
    p.add_argument("--vis", help="write visualization PNG")
    p.add_argument("--out")
    p.add_argument("--profile", action="store_true")
    p.set_defaults(func=cmd_detect)

    p = sub.add_parser("recognize", help="recognize word crops")
    p.add_argument("images", nargs="+")
    p.add_argument("--weights")
    p.add_argument("--mode", choices=["beam", "greedy"], default="beam")
    p.add_argument("--beam-size", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=32)
    p.set_defaults(func=cmd_recognize)

    p = sub.add_parser("bench", help="run the standard benchmark on the card")
    p.set_defaults(func=cmd_bench)

    p = sub.add_parser(
        "sweep-report",
        help="summarize a hyperparameter study (utils.sweep storage) and optionally render "
             "a self-contained HTML report",
    )
    p.add_argument("storage", help=".json or .db/.sqlite study storage")
    p.add_argument("--out", help="write an HTML report here")
    p.set_defaults(func=cmd_sweep_report)

    p = sub.add_parser("serve", help="HTTP OCR server with micro-batching")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--mode", choices=["beam", "greedy"], default="beam")
    p.add_argument("--batch-pages", type=int, default=4,
                   help="max pages coalesced into one device pass")
    p.add_argument("--batch-wait-ms", type=float, default=25.0,
                   help="max extra latency a request pays waiting for batch-mates")
    p.add_argument("--max-words", default="auto", type=_max_words)
    p.add_argument("--crop-source", choices=["native", "device"], default="native",
                   help="crop source (see 'ocr --crop-source')")
    p.add_argument("--max-queue", type=int, default=64,
                   help="bounded admission queue; a full queue returns 429")
    p.add_argument("--request-timeout-s", type=float, default=120.0,
                   help="end-to-end budget of a request; expiry returns 504")
    p.add_argument("--n-devices", type=int, default=1,
                   help="shard each micro-batch over an N-card data mesh; --batch-pages "
                        "rounds up to a multiple of N")
    p.set_defaults(func=cmd_serve)

    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
