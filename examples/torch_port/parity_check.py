"""Golden-parity check of manuscript_tpu_torch against a fixture of words.

The committed fixtures were written by the JAX package's
``examples/parity_check.py`` on the CPU, from the committed micro
checkpoints on deterministic synthetic pages. This script runs the port on
the same page and holds its words to them:

    # greedy decode, capacity 64 (the fixture's own settings)
    python examples/torch_port/parity_check.py --quality --synthetic 9100
    # beam decode, auto capacity
    python examples/torch_port/parity_check.py --quality --synthetic 9200 \\
        --fixture examples/parity_fixture_beam.json

Add ``--cpu`` to run on the CPU; without it the script runs on the CUDA
card (TF32 off, so that float32 convolutions round as on the CPU). The
fixture's ``mode`` and ``max_words`` drive the pipeline. It prints

    boxes: N matched / N fixture (IoU>=0.7 F1=1.000)
    texts: N/N exact
    PARITY OK

and each word whose text differs, and exits non-zero unless F1 ≥ 0.95 and
95 % of the matched texts are equal.

On a host with a network, the released checkpoints close the same loop:
``--pin-hashes`` fetches them (``utils.weights.fetch_artifact``) and records
their sha256 in the port's ``configs/release_hashes.json``; ``--image
page.jpg --write-fixture --fixture mine.json`` records this framework's
words on a page, and ``--image page.jpg --fixture mine.json`` checks them.
``--write-fixture`` writes only to an explicit ``--fixture`` path, and never
over the JAX package's committed fixtures.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

EXAMPLES = Path(__file__).resolve().parents[1]
DEFAULT_FIXTURE = EXAMPLES / "parity_fixture.json"
# written by the JAX package; the port only reads them
COMMITTED_FIXTURES = (DEFAULT_FIXTURE, EXAMPLES / "parity_fixture_beam.json")


def page_words(page):
    return [
        {"polygon": [[float(x), float(y)] for x, y in w.polygon], "text": w.text}
        for b in page.blocks
        for w in b.words
    ]


def axis_iou(p1, p2) -> float:
    """Axis-aligned-bbox IoU of two polygons (``utils.quality._axis_iou``)."""
    from manuscript_tpu_torch.utils.quality import _axis_iou

    return _axis_iou(np.asarray(p1, np.float32), np.asarray(p2, np.float32))


def compare(words, fixture_words, iou: float):
    """Greedy match of each fixture word to the best unused word by axis IoU
    → (matched, equal texts, F1, [(fixture text, our text)] of the matched
    words whose texts differ)."""
    matched, text_ok, used, differ = 0, 0, set(), []
    for fw in fixture_words:
        best, best_iou = None, 0.0
        for i, w in enumerate(words):
            if i in used:
                continue
            v = axis_iou(fw["polygon"], w["polygon"])
            if v > best_iou:
                best, best_iou = i, v
        if best is not None and best_iou >= iou:
            used.add(best)
            matched += 1
            if (words[best]["text"] or "") == (fw["text"] or ""):
                text_ok += 1
            else:
                differ.append((fw["text"], words[best]["text"]))
    prec = matched / max(len(words), 1)
    rec = matched / max(len(fixture_words), 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return matched, text_ok, f1, differ


def pin_hashes() -> int:
    from manuscript_tpu_torch.utils.weights import RELEASES, _sha256_of, fetch_artifact, pin_sha256

    for name in RELEASES:
        path = fetch_artifact(name)
        if path is None:
            print(f"FAILED to fetch {name}: is this host networked?")
            return 1
        digest = _sha256_of(path)
        pin_sha256(name, digest)
        print(f"pinned {name}: sha256={digest}")
    return 0


def main(argv=None) -> int:
    from manuscript_tpu_torch.utils.device import add_cpu_flag, card_name, script_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image", help="page image to OCR")
    ap.add_argument("--synthetic", type=int, metavar="SEED",
                    help="use a deterministic utils.synthetic page instead of --image")
    ap.add_argument("--quality", action="store_true",
                    help="use the committed synthetic-trained micro checkpoints "
                         "(manuscript_tpu/configs/quality) instead of released weights")
    ap.add_argument("--fixture", default=None,
                    help=f"fixture JSON (default {DEFAULT_FIXTURE.relative_to(EXAMPLES.parent)})")
    ap.add_argument("--mode", choices=("greedy", "beam"), default="greedy",
                    help="decode mode recorded by --write-fixture (a fixture's own wins)")
    ap.add_argument("--max-words", default="64",
                    help="word capacity ('auto' or an int) recorded by --write-fixture "
                         "(a fixture's own wins)")
    ap.add_argument("--write-fixture", action="store_true")
    ap.add_argument("--pin-hashes", action="store_true",
                    help="fetch the released checkpoints and pin their sha256s into "
                         "manuscript_tpu_torch/configs/release_hashes.json")
    ap.add_argument("--iou", type=float, default=0.7)
    add_cpu_flag(ap)
    args = ap.parse_args(argv)

    if args.write_fixture:
        if args.fixture is None:
            ap.error("--write-fixture needs an explicit --fixture path")
        if Path(args.fixture).resolve() in COMMITTED_FIXTURES:
            ap.error(f"{args.fixture} is a committed fixture of the JAX package; "
                     "write to another path")
    if args.pin_hashes:
        status = pin_hashes()
        if status or not args.image:
            return status
    if not args.image and args.synthetic is None:
        ap.error("--image or --synthetic is required (unless only pinning hashes)")

    import torch

    from manuscript_tpu_torch import Pipeline

    dev = script_device(args.cpu)
    # float32 convolutions round as on the CPU, where the fixtures were written
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    fixture_path = Path(args.fixture or DEFAULT_FIXTURE)
    fixture = None if args.write_fixture else json.loads(fixture_path.read_text())
    mode = fixture["mode"] if fixture else args.mode
    max_words = fixture["max_words"] if fixture else args.max_words
    capacity = max_words if max_words == "auto" else int(max_words)

    if args.quality:
        from manuscript_tpu_torch.utils.quality import load_quality_models

        east, trba = load_quality_models(dev)
        pipe = Pipeline(detector=east, recognizer=trba, device=dev, mode=mode, max_words=capacity)
    else:
        pipe = Pipeline(device=dev, mode=mode, max_words=capacity)  # released weights

    if args.synthetic is not None:
        from manuscript_tpu_torch.utils.synthetic import render_page

        image, _ = render_page(np.random.default_rng(args.synthetic))
        source = f"synthetic:{args.synthetic}"
    else:
        image, source = args.image, str(args.image)
    words = page_words(pipe.predict(image))

    if args.write_fixture:
        fixture_path.write_text(json.dumps(
            {"image": source, "mode": mode, "max_words": max_words, "words": words},
            ensure_ascii=False, indent=1,
        ))
        print(f"wrote {len(words)} words to {fixture_path}")
        return 0

    matched, text_ok, f1, differ = compare(words, fixture["words"], args.iou)
    print(f"device: {card_name(dev)}; fixture {fixture_path.name} ({source}, mode {mode}, "
          f"max_words {max_words})")
    print(f"boxes: {matched} matched / {len(fixture['words'])} fixture "
          f"(IoU>={args.iou} F1={f1:.3f})")
    print(f"texts: {text_ok}/{matched} exact")
    for want, got in differ:
        print(f"  differs: fixture {want!r}, port {got!r}")
    ok = f1 >= 0.95 and text_ok >= int(0.95 * max(matched, 1))
    print("PARITY OK" if ok else "PARITY FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
