"""The port's quality harness against the JAX package on the CPU: the numpy
page renderer byte-equal to the PIL one, the metrics equal on the same
inputs, ``evaluate_quality`` equal on held-out pages, the committed parity
fixtures reproduced, and the reference numbers that ``chip_smoke.py`` holds
the card to.

``manuscript_tpu_torch/configs/quality_reference.json`` holds the JAX
package's ``evaluate_quality(n_pages=8, seed=9000, mode="beam")`` for native
crops, device crops, ``crop_scale=2`` and the classic path
(``use_fused=False``), on the CPU. It is written by

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_quality.py

and the ``slow`` test below computes it again and compares.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from manuscript_tpu.train.metrics import _edit_distance as j_edit_distance
from manuscript_tpu.train.metrics import compute_f1 as j_compute_f1
from manuscript_tpu.utils import quality as jq
from manuscript_tpu.utils import synthetic as js
from manuscript_tpu_torch.types import Block, Page, Word
from manuscript_tpu_torch.utils import metrics as tm
from manuscript_tpu_torch.utils import quality as tq
from manuscript_tpu_torch.utils import synthetic as ts

ROOT = Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "manuscript_tpu_torch" / "configs" / "quality_reference.json"
REFERENCE_CALLS = {
    "native": {},
    "device": {"crop_source": "device"},
    "crop_scale_2": {"crop_scale": 2},
    "classic": {"use_fused": False},
}
REFERENCE_ARGS = {"n_pages": 8, "seed": 9000, "mode": "beam"}
COMMAND = "JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_quality.py"


@pytest.fixture(scope="module")
def jax_models():
    return jq.load_quality_models()


@pytest.fixture(scope="module")
def port_models():
    return tq.load_quality_models("cpu")


@pytest.mark.parametrize("seed", [9000, 9100, 9200])
def test_render_page_is_byte_equal_to_jax(seed):
    ref, ref_gt = js.render_page(np.random.default_rng(seed))
    got, got_gt = ts.render_page(np.random.default_rng(seed))
    assert got.dtype == np.uint8 and np.array_equal(got, ref)
    assert [w["text"] for w in got_gt] == [w["text"] for w in ref_gt]
    for a, b in zip(got_gt, ref_gt):
        np.testing.assert_array_equal(a["quad"], b["quad"])
    assert ts.VOCAB == js.VOCAB


def test_quality_ckpts_available_and_the_missing_file_named(tmp_path):
    """A checkout holds the micro checkpoints, as the JAX package finds them;
    a directory without them is not available, and loading from it raises
    with the full path of the first missing file and where to find them."""
    assert tq.quality_ckpts_available() and jq.quality_ckpts_available()
    assert tq.QUALITY_DIR.resolve() == jq.QUALITY_DIR.resolve()
    assert not tq.quality_ckpts_available(tmp_path)
    for present in ((), ("east_micro.json", "east_micro.msgpack")):
        for name in present:
            shutil.copy(tq.QUALITY_DIR / name, tmp_path / name)
        missing = "trba_micro.msgpack" if present else "east_micro.json"
        assert not tq.quality_ckpts_available(str(tmp_path))
        with pytest.raises(FileNotFoundError) as err:
            tq.load_quality_models("cpu", directory=tmp_path)
        assert str(tmp_path.resolve() / missing) in str(err.value)
        assert all(s in str(err.value) for s in ("manuscript_tpu/configs/quality/", "directory="))
    shutil.copy(tq.QUALITY_DIR / "trba_micro.msgpack", tmp_path)
    assert tq.quality_ckpts_available(tmp_path)


def test_edit_distance_matches_jax():
    rng = np.random.default_rng(0)
    letters = list("abcdeé ")
    for _ in range(300):
        a = "".join(rng.choice(letters, rng.integers(0, 9)))
        b = "".join(rng.choice(letters, rng.integers(0, 9)))
        assert tm._edit_distance(a, b) == j_edit_distance(a, b)


def _jittered_pages(rng, n_pages=3):
    """Predicted pages made from ground truth: boxes jittered and rotated,
    some words missed, some false boxes, some texts misspelled."""
    gt_pages, pred_pages = [], []
    for _ in range(n_pages):
        _, gt = ts.render_page(rng)
        words = []
        for g in gt:
            if rng.uniform() < 0.1:
                continue
            th = rng.uniform(-0.1, 0.1)
            rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
            c = g["quad"].mean(0)
            quad = (g["quad"] - c) @ rot.T + c + rng.normal(0, 3, (4, 2))
            text = g["text"] if rng.uniform() < 0.7 else g["text"][::-1][: rng.integers(1, 6)]
            words.append(Word(polygon=quad.tolist(), text=text, detection_confidence=0.9))
        for _ in range(2):
            x, y = rng.uniform(0, 700, 2)
            words.append(Word(polygon=[[x, y], [x + 50, y], [x + 50, y + 20], [x, y + 20]],
                              text="ink", detection_confidence=0.5))
        gt_pages.append(gt)
        pred_pages.append(Page(blocks=[Block(words=words)]))
    return pred_pages, gt_pages


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_compute_f1_matches_jax(thresh):
    pred_pages, gt_pages = _jittered_pages(np.random.default_rng(1))
    preds = [{"image_id": i, "segmentation": np.asarray(w.polygon, np.float32).ravel()}
             for i, p in enumerate(pred_pages) for b in p.blocks for w in b.words]
    gt = {i: [w["quad"].ravel() for w in g] for i, g in enumerate(gt_pages)}
    ids = list(range(len(gt_pages)))
    got = tm.compute_f1(preds, thresh, gt, ids)
    assert got == j_compute_f1(preds, thresh, gt, ids)
    assert 0.5 < got < 1.0


def test_score_pages_matches_jax():
    pred_pages, gt_pages = _jittered_pages(np.random.default_rng(2))
    got = tq.score_pages(pred_pages, gt_pages)
    assert got == jq.score_pages(pred_pages, gt_pages)
    assert 0.0 < got["e2e_cer"] < 0.5 and got["n_gt_words"] == 72


@pytest.mark.parametrize("call", ["native", "device", "classic"])
def test_evaluate_quality_matches_jax(jax_models, port_models, call):
    """Two held-out pages, greedy: native crops and the classic path
    (``use_fused=False``: ``EAST.predict`` with the host LANMS, host crops,
    ``TRBA.predict``) give the JAX package's numbers exactly; device crops
    the same F1 and CER within 0.01 (their bf16 crop products may move a
    pixel by one level)."""
    kw = dict(n_pages=2, seed=9000, mode="greedy", **REFERENCE_CALLS[call])
    ref = jq.evaluate_quality(models=jax_models, **kw)
    got = tq.evaluate_quality(models=port_models, **kw)
    if call == "device":
        assert got["detector_f1"] == ref["detector_f1"]
        assert abs(got["e2e_cer"] - ref["e2e_cer"]) <= 0.01
    else:
        assert got == ref
    assert got["detector_f1"] > 0.95


@pytest.mark.parametrize("fixture_name", ["parity_fixture.json", "parity_fixture_beam.json"])
def test_parity_fixture_reproduces(fixture_name):
    """The JAX package's golden pages (greedy at capacity 64, seed 9100; beam
    at auto capacity, seed 9200) through the port's ``Pipeline.predict``:
    F1 ≥ 0.95 at axis-aligned IoU 0.7 and ≥ 95 % of matched texts equal, the
    criteria of ``tests/test_quality_gate.py``."""
    from manuscript_tpu_torch import Pipeline

    # fresh models: auto capacity shrinks the detector's max_boxes
    fixture = json.loads((ROOT / "examples" / fixture_name).read_text())
    seed = int(fixture["image"].split(":")[1])
    mw = fixture.get("max_words", "64")
    east, trba = tq.load_quality_models("cpu")
    pipe = Pipeline(east, trba, device="cpu", mode=fixture.get("mode", "greedy"),
                    max_words=mw if mw == "auto" else int(mw))
    image, _ = ts.render_page(np.random.default_rng(seed))
    words = [w for b in pipe.predict(image).blocks for w in b.words]
    fwords = fixture["words"]
    matched = text_ok = 0
    used = set()
    for fw in fwords:
        best, best_iou = None, 0.0
        for i, w in enumerate(words):
            if i in used:
                continue
            iou = tq._axis_iou(np.asarray(fw["polygon"], np.float32),
                               np.asarray(w.polygon, np.float32))
            if iou > best_iou:
                best, best_iou = i, iou
        if best is not None and best_iou >= 0.7:
            used.add(best)
            matched += 1
            text_ok += (words[best].text or "") == (fw["text"] or "")
    prec, rec = matched / max(len(words), 1), matched / max(len(fwords), 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    assert f1 >= 0.95, (f1, matched, len(fwords), len(words))
    assert text_ok >= int(0.95 * max(matched, 1)), (text_ok, matched)


@pytest.mark.parametrize("name", list(REFERENCE_CALLS))
def test_reference_numbers_hold_on_cpu(port_models, name):
    """The port on the CPU meets the JAX package's reference numbers with
    the tolerances ``chip_smoke.py`` phase 7 holds the card to."""
    ref = json.loads(REFERENCE.read_text())
    assert ref["args"] == REFERENCE_ARGS and ref["command"] == COMMAND
    got = tq.evaluate_quality(models=port_models, **REFERENCE_ARGS, **REFERENCE_CALLS[name])
    assert round(got["detector_f1"], 3) == round(ref[name]["detector_f1"], 3), got
    assert abs(got["e2e_cer"] - ref[name]["e2e_cer"]) <= 0.005, got


def jax_reference(models=None) -> dict:
    models = models or jq.load_quality_models()
    out = {"command": COMMAND, "args": REFERENCE_ARGS}
    for name, kw in REFERENCE_CALLS.items():
        m = jq.evaluate_quality(models=models, **REFERENCE_ARGS, **kw)
        out[name] = {k: m[k] for k in ("detector_f1", "e2e_cer", "word_acc", "n_gt_words")}
    return out


@pytest.mark.slow
def test_quality_reference_regenerates_from_jax(jax_models):
    assert jax_reference(jax_models) == json.loads(REFERENCE.read_text())


if __name__ == "__main__":
    REFERENCE.write_text(json.dumps(jax_reference(), indent=1) + "\n")
    print(REFERENCE.read_text())
