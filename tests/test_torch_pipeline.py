"""The port's page pipeline against the JAX package end to end on the CPU:
the committed micro checkpoints on 2 pages from the JAX package's synthetic
renderer, ``Pipeline(device="cpu", max_words=32)`` against
``Pipeline(fused=True, crop_source="native", max_words=32)``: the same word
count, boxes within 1e-2 px, equal texts. Also the page fixture that
chip_smoke.py reads, and the refusal to run without a card by default."""

import json

import numpy as np
import pytest
import torch

from manuscript_tpu.pipeline import Pipeline as JaxPipeline
from manuscript_tpu.utils.quality import QUALITY_DIR, load_quality_models
from manuscript_tpu.utils.synthetic import VOCAB, render_page, render_word
from manuscript_tpu_torch import EAST, TRBA, Pipeline
from manuscript_tpu_torch.fused import FusedOCR

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

FIXTURE = QUALITY_DIR.parents[1].parent / "manuscript_tpu_torch" / "configs" / "synthetic_page.npz"


def port_models(device="cpu", **kw):
    meta = json.loads((QUALITY_DIR / "east_micro.json").read_text())
    east = EAST(QUALITY_DIR / "east_micro.msgpack", device=device, backbone=meta["backbone"],
                target_size=meta["target_size"], score_thresh=meta["score_thresh"],
                expand_ratio_w=meta["expand_ratio"], expand_ratio_h=meta["expand_ratio"],
                quantization=meta["quantization"], max_candidates=2048, max_boxes=256,
                dtype=torch.float32, **kw)
    return east, TRBA(QUALITY_DIR / "trba_micro.msgpack", device=device)


@pytest.fixture(scope="module")
def pipelines():
    east, trba = load_quality_models()
    jax_pipe = JaxPipeline(east, trba, fused=True, crop_source="native", max_words=32)
    return jax_pipe, Pipeline(*port_models(), device="cpu", max_words=32)


def _words(page):
    return [w for block in page.blocks for w in block.words]


@pytest.mark.parametrize("seed", [123, 321])
def test_pipeline_matches_jax_on_synthetic_pages(pipelines, seed):
    jax_pipe, pipe = pipelines
    img, gt = render_page(np.random.default_rng(seed))
    ref, got = _words(jax_pipe.predict(img)), _words(pipe.predict(img))
    assert len(got) == len(ref) >= len(gt) - 2
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.polygon, b.polygon, atol=1e-2, rtol=0)
        assert a.text == b.text
        assert a.detection_confidence == pytest.approx(b.detection_confidence, abs=1e-4)
        if b.recognition_confidence is not None:
            assert a.recognition_confidence == pytest.approx(b.recognition_confidence, abs=1e-4)
    assert sum(w.text in VOCAB for w in got) >= len(gt) // 2
    assert Pipeline.get_text(pipe.predict(img)) == jax_pipe.get_text(jax_pipe.predict(img))


def test_word_capacity_auto_and_overflow_follow_jax():
    east, trba = port_models()
    f = FusedOCR(east, trba, max_words="auto")
    f._apply_capacity(40)  # 40 ≤ 64 − 8 → bucket 64, boxes max(256, 4·64)
    assert (f.max_words, east.max_boxes) == (64, 256)
    assert f._chunk_bucket(10) == 32  # a sparse page takes the small bucket
    assert f._chunk_bucket(100) == 128 and f.max_words == 128  # a dense one grows it
    assert f.last_overflow == 36
    pinned = FusedOCR(east, trba, max_words=32)
    assert pinned._chunk_bucket(100) == 32


def test_process_batch_is_one_page_after_another():
    pipe = Pipeline(*port_models(), device="cpu", max_words=32)
    img, _ = render_page(np.random.default_rng(7))
    pages = pipe.process_batch([img, img])
    assert len(pages) == 2
    assert [w.text for w in _words(pages[0])] == [w.text for w in _words(pages[1])]
    assert set(pipe._fused.last_timings) >= {"detect", "crops", "recognize"}


def clean_page(seed=123, page_h=1024, page_w=768, n_rows=8, n_cols=3):
    """``render_page``'s layout and words without its pixel noise, as one
    gray channel: the page fixture chip_smoke.py adds its own noise to."""
    rng = np.random.default_rng(seed)
    page = np.full((page_h, page_w), 235, np.uint8)
    cell_h, cell_w = page_h // (n_rows + 1), page_w // n_cols
    for r in range(n_rows):
        for c in range(n_cols):
            text = str(VOCAB[int(rng.integers(len(VOCAB)))])
            crop = render_word(text, rng, height=36, noise=0.0)[..., 0]
            ch, cw = crop.shape
            if cw > cell_w - 16:
                crop = crop[:, : cell_w - 16]
                cw = crop.shape[1]
            y = (r + 1) * cell_h + int(rng.integers(-8, 9)) - ch // 2
            x = c * cell_w + 8 + int(rng.integers(0, max(1, cell_w - cw - 16)))
            y, x = int(np.clip(y, 0, page_h - ch)), int(np.clip(x, 0, page_w - cw))
            page[y : y + ch, x : x + cw] = crop
    return page


def test_page_fixture_is_the_rendered_clean_page():
    np.testing.assert_array_equal(np.load(FIXTURE)["page"], clean_page())


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Pipeline()
    with pytest.raises(RuntimeError, match="CUDA"):
        EAST(allow_random_init=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        TRBA(device="cuda", allow_random_init=True)


def test_wrappers_never_init_silently(monkeypatch, tmp_path):
    # no checkpoint given or cached, and random weights not allowed by the
    # environment (tests/conftest.py allows them for the JAX package's tests)
    monkeypatch.delenv("MANUSCRIPT_TPU_ALLOW_RANDOM_INIT")
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.raises(ValueError, match="allow_random_init"):
        EAST(device="cpu")
    with pytest.raises(ValueError, match="allow_random_init"):
        TRBA(device="cpu")


def test_pipeline_refuses_parts_on_another_device():
    east, trba = port_models()
    east.device = torch.device("cuda")
    with pytest.raises(ValueError, match="EAST"):
        Pipeline(east, trba, device="cpu")
