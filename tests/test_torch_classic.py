"""The classic host path of the port against the JAX package's on the CPU:
``Pipeline(fused=False)`` (``EAST.predict`` with the host LANMS, host crops,
``TRBA.predict``) on the committed micro checkpoints, TF32 off; the
duck-typed detector/recognizer contract of ``tests/pipeline/
test_pipeline_api.py``; and ``TRBA.predict``'s batching and path errors.

Tolerances: the same word count and texts, polygons within 1e-2 px and
recognition confidences within 1e-4 (float32 sums in another order)."""

import json
import shutil

import numpy as np
import pytest
import torch

from manuscript_tpu.pipeline import Pipeline as JaxPipeline
from manuscript_tpu.utils.quality import QUALITY_DIR, load_quality_models
from manuscript_tpu_torch import Pipeline
from manuscript_tpu_torch.recognizers import TRBA
from manuscript_tpu_torch.types import Block, Page, Word
from manuscript_tpu_torch.utils.quality import load_quality_models as port_models
from manuscript_tpu_torch.utils.synthetic import render_page

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CKPT = QUALITY_DIR / "trba_micro.msgpack"


@pytest.fixture(scope="module")
def pipelines():
    jax_pipe = JaxPipeline(*load_quality_models(), fused=False, mode="greedy")
    pipe = Pipeline(*port_models("cpu"), device="cpu", fused=False, mode="greedy")
    return jax_pipe, pipe


@pytest.fixture(scope="module")
def pages():
    return [render_page(np.random.default_rng(s))[0] for s in (9000, 9100, 9200)]


def _words(page):
    return [w for b in page.blocks for w in b.words]


def assert_same_page(got, ref):
    gw, rw = _words(got), _words(ref)
    assert len(gw) == len(rw) > 0
    assert [w.text for w in gw] == [w.text for w in rw]
    for a, b in zip(gw, rw):
        np.testing.assert_allclose(a.polygon, b.polygon, atol=1e-2, rtol=0)
        assert (a.recognition_confidence is None) == (b.recognition_confidence is None)
        if b.recognition_confidence is not None:
            assert a.recognition_confidence == pytest.approx(b.recognition_confidence, abs=1e-4)


def test_classic_predict_matches_jax(pipelines, pages):
    jax_pipe, pipe = pipelines
    assert pipe._fused is None
    got, ref = pipe.predict(pages[0]), jax_pipe.predict(pages[0])
    assert_same_page(got, ref)
    assert pipe.get_text(got) == jax_pipe.get_text(ref)
    assert sum(w.text is not None for w in _words(got)) > 20


def test_classic_process_batch_matches_jax(pipelines, pages):
    """Batched detection (chunks of 2, one short) and one recognizer call
    for all pages' crops, against the JAX package's and the predict loop."""
    jax_pipe, pipe = pipelines
    got = pipe.process_batch(pages, detector_batch_size=2)
    ref = jax_pipe.process_batch(pages, detector_batch_size=2)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert_same_page(g, r)
    assert [w.text for w in _words(got[1])] == [w.text for w in _words(pipe.predict(pages[1]))]
    handle = pipe.start_batch(pages[:1])
    assert handle[0] == "classic"
    assert [w.text for w in _words(pipe.finish_batch(handle)[0])] == [w.text for w in _words(got[0])]


def test_fused_auto_takes_the_port_wrappers_and_true_refuses_duck_types():
    east, trba = port_models("cpu")
    assert Pipeline(east, trba, device="cpu")._fused is not None
    assert Pipeline(DummyDetector(), DummyRecognizer(), device="cpu")._fused is None
    with pytest.raises(ValueError, match="fused=True"):
        Pipeline(DummyDetector(), DummyRecognizer(), device="cpu", fused=True)


# ---- the duck-typed contract (tests/pipeline/test_pipeline_api.py) -----------


def _page(polys=None):
    polys = polys or [[(10, 10), (90, 10), (90, 40), (10, 40)]]
    return Page(blocks=[Block(words=[Word(polygon=p, detection_confidence=0.9) for p in polys])])


class DummyDetector:
    def __init__(self, fmt="dict", polys=None):
        self.fmt, self.polys, self.calls = fmt, polys, 0

    def predict(self, image, vis=False, profile=False):
        self.calls += 1
        page = _page(self.polys)
        return {"dict": {"page": page, "vis_image": None}, "tuple": (page, None),
                "bare": page, "nopage": {"vis_image": None}}[self.fmt]


class BatchedDummyDetector(DummyDetector):
    def predict_batch(self, images, batch_size=1, vis=False, profile=False):
        self.calls += 1
        return [{"page": _page(self.polys), "vis_image": None} for _ in images]


class DummyRecognizer:
    def __init__(self, result_fmt="dict"):
        self.result_fmt, self.calls, self.num_images = result_fmt, 0, 0

    def predict(self, images):
        self.calls += 1
        self.num_images += len(images)
        n = range(len(images))
        return {"dict": [{"text": f"w{i}", "confidence": 0.5} for i in n],
                "tuple": [(f"w{i}", 0.5) for i in n], "bare": [f"w{i}" for i in n]}[self.result_fmt]


class KwargsRecognizer(DummyRecognizer):
    def predict(self, images, mode="beam", beam_size=8, alpha=0.9, temperature=1.7):
        self.seen = dict(mode=mode, beam_size=beam_size, alpha=alpha, temperature=temperature)
        return super().predict(images)


@pytest.fixture
def image():
    return np.full((100, 100, 3), 255, dtype=np.uint8)


@pytest.mark.parametrize("fmt", ["dict", "tuple", "bare"])
@pytest.mark.parametrize("result_fmt", ["dict", "tuple", "bare"])
def test_detector_and_recognizer_formats(image, fmt, result_fmt):
    pipe = Pipeline(DummyDetector(fmt=fmt), DummyRecognizer(result_fmt), device="cpu")
    word = pipe.predict(image).blocks[0].words[0]
    assert word.text == "w0"
    assert word.recognition_confidence == (None if result_fmt == "bare" else pytest.approx(0.5))


def test_detector_without_page_raises(image):
    with pytest.raises(RuntimeError, match="Page"):
        Pipeline(DummyDetector(fmt="nopage"), DummyRecognizer(), device="cpu").predict(image)


def test_empty_page_and_small_words_never_reach_the_recognizer(image):
    for polys in ([[(0, 0), (3, 0), (3, 3), (0, 3)]],):
        rec = DummyRecognizer()
        Pipeline(DummyDetector(polys=polys), rec, device="cpu").predict(image)
        assert rec.calls == 0

    class EmptyDetector(DummyDetector):
        def predict(self, image, vis=False, profile=False):
            return Page(blocks=[Block(words=[])])

    rec = DummyRecognizer()
    page = Pipeline(EmptyDetector(), rec, device="cpu").predict(image)
    assert rec.calls == 0 and page.blocks[0].words == []


def test_recognize_text_false_skips_the_recognizer(image):
    rec = DummyRecognizer()
    pipe = Pipeline(BatchedDummyDetector(), rec, device="cpu")
    assert pipe.predict(image, recognize_text=False).blocks[0].words[0].text is None
    assert all(p.blocks[0].words[0].text is None
               for p in pipe.process_batch([image, image], recognize_text=False))
    assert rec.calls == 0


def test_process_batch_uses_predict_batch_and_one_recognizer_call(image):
    det, rec = BatchedDummyDetector(), DummyRecognizer()
    pages = Pipeline(det, rec, device="cpu").process_batch([image] * 3)
    assert len(pages) == 3 and det.calls == 1 and rec.calls == 1
    plain = Pipeline(DummyDetector(), DummyRecognizer(), device="cpu").process_batch([image] * 2)
    assert [p.blocks[0].words[0].text for p in plain] == ["w0", "w0"]


def test_reading_order_and_decode_settings(image):
    line2 = [(10, 60), (90, 60), (90, 80), (10, 80)]
    line1 = [(10, 10), (90, 10), (90, 30), (10, 30)]
    rec = KwargsRecognizer()
    pipe = Pipeline(DummyDetector(polys=[line2, line1]), rec, device="cpu", mode="greedy", beam_size=3)
    page = pipe.predict(image)
    assert [w.polygon[0][1] for w in page.blocks[0].words] == [10, 60]
    assert rec.seen == dict(mode="greedy", beam_size=3, alpha=0.9, temperature=1.7)
    # vis=True: (page, drawn page), the page's size, the words in reading order
    page, vis = pipe.predict(image, vis=True)
    assert [w.polygon[0][1] for w in page.blocks[0].words] == [10, 60]
    assert vis.size == (image.shape[1], image.shape[0])


# ---- TRBA.predict ---------------------------------------------------------------


@pytest.fixture(scope="module")
def trbas():
    from manuscript_tpu.recognizers import TRBA as JaxTRBA

    return JaxTRBA(model_path=str(CKPT)), TRBA(CKPT, device="cpu")


def crops(n, seed=0):
    from manuscript_tpu_torch.utils.synthetic import VOCAB, render_word

    rng = np.random.default_rng(seed)
    return [render_word(VOCAB[int(rng.integers(len(VOCAB)))], rng) for _ in range(n)]


def test_trba_predict_batches_match_jax(trbas):
    jax_rec, rec = trbas
    images = crops(5)
    whole = rec.predict(images, mode="greedy")
    for batch_size in (1, 2):
        got = rec.predict(images, batch_size=batch_size, mode="greedy")
        assert [r["text"] for r in got] == [r["text"] for r in whole]
        np.testing.assert_allclose([r["confidence"] for r in got],
                                   [r["confidence"] for r in whole], atol=1e-5, rtol=0)
    ref = jax_rec.predict(images, batch_size=2, mode="beam", beam_size=3)
    got = rec.predict(images, batch_size=2, mode="beam", beam_size=3)
    assert [r["text"] for r in got] == [r["text"] for r in ref]
    np.testing.assert_allclose([r["confidence"] for r in got], [r["confidence"] for r in ref],
                               atol=1e-4, rtol=0)
    assert rec.predict([]) == [] and len(rec.predict(images[0], mode="greedy")) == 1
    with pytest.raises(ValueError):
        rec.predict(images, mode="magic")


def test_trba_paths(tmp_path, trbas):
    _, rec = trbas
    with pytest.raises(FileNotFoundError):
        rec.predict(str(tmp_path / "missing.png"))
    with pytest.raises(FileNotFoundError):
        TRBA(tmp_path / "missing.msgpack", device="cpu")
    with pytest.raises(ValueError, match="either"):
        TRBA(CKPT, device="cpu", weights_path=tmp_path / "other.msgpack")
    with pytest.raises(TypeError):
        TRBA(CKPT, device="cpu", bogus=1)
    with pytest.raises(FileNotFoundError):
        TRBA(CKPT, device="cpu", charset_path=tmp_path / "missing.txt")
    assert TRBA(weights_path=CKPT, device="cpu").itos == rec.itos
    # a sidecar <checkpoint>.json config wins over the embedded one
    ckpt = tmp_path / "trba.msgpack"
    shutil.copy(CKPT, ckpt)
    config = {"max_len": 5, "hidden_size": rec.hidden_size, "img_h": rec.img_h, "img_w": rec.img_w,
              "cnn_stage_plan": rec.cnn_stage_plan}
    ckpt.with_suffix(".json").write_text(json.dumps(config))
    side = TRBA(ckpt, device="cpu")
    assert side.max_length == 5 and side.config_path == ckpt.with_suffix(".json")
    # a charset file replaces the embedded charset
    charset = tmp_path / "charset.txt"
    charset.write_text("\n".join(rec.itos) + "\n", encoding="utf-8")
    assert TRBA(CKPT, charset_path=charset, device="cpu").itos == rec.itos


def test_trba_weights_from_cache_and_environment(tmp_path, monkeypatch):
    """No model_path: the first checkpoint under ~/.manuscript_tpu/trba;
    with none there, random weights only when the environment allows."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("MANUSCRIPT_TPU_ALLOW_RANDOM_INIT", raising=False)
    with pytest.raises(ValueError, match="MANUSCRIPT_TPU_ALLOW_RANDOM_INIT"):
        TRBA(device="cpu")
    cache = tmp_path / ".manuscript_tpu" / "trba"
    cache.mkdir(parents=True)
    shutil.copy(CKPT, cache / "trba.msgpack")
    rec = TRBA(device="cpu")
    assert rec.model_path == cache / "trba.msgpack" and rec.cnn_stage_plan != "full"
