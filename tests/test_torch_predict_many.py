"""Many pages through the port on the CPU, with the committed micro
checkpoints and held-out synthetic pages (``max_words=32``, greedy):
``process_batch`` (native crops, 2 pages a chunk, so the last chunk of 5 is
short) against the port's own ``predict`` loop and the JAX package's
``process_batch``; the device-crop path against the JAX package's;
``calibrate``; and ``start_batch``/``finish_batch``. Texts equal, boxes
within 1e-2 px."""

import numpy as np
import pytest
import torch

from manuscript_tpu.fused import FusedOCR as JaxFusedOCR
from manuscript_tpu.pipeline import Pipeline as JaxPipeline
from manuscript_tpu.utils.quality import load_quality_models as jax_models_load
from manuscript_tpu_torch import Pipeline
from manuscript_tpu_torch.fused import FusedOCR
from manuscript_tpu_torch.ops.image import detector_preprocess_host
from manuscript_tpu_torch.utils.quality import load_quality_models
from manuscript_tpu_torch.utils.synthetic import eval_pages

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

KW = dict(max_words=32, mode="greedy")


@pytest.fixture(scope="module")
def jax_models():
    return jax_models_load()


@pytest.fixture(scope="module")
def pages():
    return [p for p, _ in eval_pages(5, seed=9100)]


def _words(page):
    return [w for block in page.blocks for w in block.words]


def assert_same_pages(got, ref, box_atol=1e-2, max_text_diffs=0):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        gw, rw = _words(g), _words(r)
        assert len(gw) == len(rw) > 0
        for a, b in zip(gw, rw):
            np.testing.assert_allclose(a.polygon, b.polygon, atol=box_atol, rtol=0)
        assert sum(a.text != b.text for a, b in zip(gw, rw)) <= max_text_diffs


def counting(recognizer):
    """Count the recognizer's phase-B passes and the crops each one takes."""
    calls = []
    inner = recognizer.recognize_tensor

    def wrapped(crops, *args, **kw):
        calls.append(crops.shape[0])
        return inner(crops, *args, **kw)

    recognizer.recognize_tensor = wrapped
    return calls


def test_process_batch_equals_predict_loop_and_jax(jax_models, pages):
    east, trba = load_quality_models("cpu")
    pipe = Pipeline(east, trba, device="cpu", batch_pages=2, **KW)
    assert pipe.batch_pages == 2
    calls = counting(trba)
    got = pipe.process_batch(pages)
    # three chunks (2, 2, 1 pages), one phase-B pass each over its pages' slots
    assert [t["pages"] for t in pipe._fused.chunk_timings] == [2, 2, 1]
    assert calls == [2 * 32, 2 * 32, 32]
    assert_same_pages(got, [pipe.predict(p) for p in pages])
    ref = JaxPipeline(*jax_models, fused=True, crop_source="native", batch_pages=2,
                      **KW).process_batch(pages)
    assert_same_pages(got, ref)
    assert sum(w.text is not None for p in got for w in _words(p)) >= 100


def test_device_crops_match_jax(jax_models, pages):
    """The one-program path (crops gathered from the detector copy in
    bfloat16) on 2 pages: the same boxes; texts equal but for at most one
    word a page, the room the ±1-level bf16 crop delta is given."""
    east, trba = load_quality_models("cpu")
    pipe = Pipeline(east, trba, device="cpu", crop_source="device", batch_pages=2, **KW)
    got = pipe.process_batch(pages[:2])
    ref = JaxPipeline(*jax_models, fused=True, crop_source="device", batch_pages=2,
                      **KW).process_batch(pages[:2])
    assert_same_pages(got, ref, max_text_diffs=1)
    assert_same_pages(got, [pipe.predict(p) for p in pages[:2]])


def test_calibrate_matches_jax(jax_models, pages):
    east, trba = load_quality_models("cpu")
    j_east = jax_models[0]
    thresh, boxes = j_east.score_thresh, j_east.max_boxes
    try:
        ref = JaxFusedOCR(*jax_models, max_words="auto").calibrate(pages[0], target_max_words=20)
        f = FusedOCR(east, trba, max_words="auto")
        assert f.calibrate(pages[0], target_max_words=20) == ref
        assert east.score_thresh == j_east.score_thresh == ref[0]
        assert (f.max_words, east.max_boxes) == (32, 256)
    finally:
        j_east.score_thresh, j_east.max_boxes = thresh, boxes


def test_auto_capacity_counts_the_first_page(pages):
    east, trba = load_quality_models("cpu")
    f = FusedOCR(east, trba, max_words="auto", mode="greedy", batch_pages=2)
    n = int(f._count_words(
        detector_preprocess_host(pages[0], east.target_size), (east.score_thresh,),
        pages[0].shape[1] / east.target_size, pages[0].shape[0] / east.target_size,
    )[0])
    out = f.predict_many(pages[:3])
    assert 20 <= n <= 26 and f.max_words == 32  # 24 words per page
    assert [len(_words(p)) for p in out] == [len(_words(f.predict(p))) for p in pages[:3]]


@pytest.mark.parametrize("crop_source", ["native", "device"])
def test_overflowing_page_grows_the_capacity(jax_models, pages, crop_source):
    """Auto capacity sized for 4 words on buckets of 8..64, one chunk of two
    pages of ~24 words: the capacity grows to 32. The native path grows it
    before phase B, so both pages equal a run pinned at 32. The device path
    runs the first page again at 32 and, as the JAX package does, not the
    second (the capacity no longer grows): that page keeps 8 texts, and the
    pages equal the JAX package's."""
    east, trba = load_quality_models("cpu")
    f = FusedOCR(east, trba, max_words="auto", mode="greedy", batch_pages=2,
                 crop_source=crop_source)
    f.CAPACITY_BUCKETS = (8, 16, 32, 64)
    f._apply_capacity(4)
    assert f.max_words == 8
    got = f.predict_many(pages[:2])
    assert f.max_words == 32 and f.last_overflow >= 16
    ref = FusedOCR(*load_quality_models("cpu"), max_words=32, mode="greedy",
                   crop_source=crop_source).predict_many(pages[:2])
    texts = [[w.text is not None for w in _words(p)] for p in got]
    if crop_source == "native":
        assert_same_pages(got, ref, box_atol=0)
        assert all(all(t) for t in texts)
        return
    assert_same_pages(got[:1], ref[:1], box_atol=0)
    assert all(texts[0]) and sum(texts[1]) == 8 < len(texts[1])
    j_east = jax_models[0]
    boxes = j_east.max_boxes
    try:
        jf = JaxFusedOCR(*jax_models, max_words="auto", mode="greedy", batch_pages=2,
                         crop_source="device", capacity_buckets=(8, 16, 32, 64))
        jf._apply_capacity(4)
        jref = jf.predict_many(pages[:2])
    finally:
        j_east.max_boxes = boxes
    assert jf.max_words == 32
    assert texts == [[w.text is not None for w in _words(p)] for p in jref]
    assert_same_pages(got, jref, max_text_diffs=1)


def test_start_and_finish_batch_give_process_batch_pages(pages):
    east, trba = load_quality_models("cpu")
    pipe = Pipeline(east, trba, device="cpu", batch_pages=2, **KW)
    ref = pipe.process_batch(pages)
    first = pipe.start_batch(pages[:3])  # split into chunks of 2 and 1
    second = pipe.start_batch(pages[3:])
    got = pipe.finish_batch(first) + pipe.finish_batch(second)
    assert_same_pages(got, ref, box_atol=0)
    dpipe = Pipeline(east, trba, device="cpu", batch_pages=2, crop_source="device", **KW)
    handle = dpipe.start_batch(pages[:3])
    assert_same_pages(dpipe.finish_batch(handle), dpipe.process_batch(pages[:3]), box_atol=0)


def test_options_are_checked():
    east, trba = load_quality_models("cpu")
    with pytest.raises(ValueError, match="crop_source"):
        FusedOCR(east, trba, crop_source="host")
    with pytest.raises(ValueError, match="crop_scale"):
        FusedOCR(east, trba, crop_scale=0)
    assert FusedOCR(east, trba, crop_scale=2).crop_source == "device"
