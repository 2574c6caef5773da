"""The port's drawing of results (``manuscript_tpu_torch/utils/visualize.py``,
no OpenCV) against the JAX package's (cv2 and PIL) on the CPU.

Measured here: ``gaussian_blur`` is cv2's ``GaussianBlur`` of a float32 mask
to within one float32 step (1.2e-7; equal for kernels up to 7); the JET
table and ``_colormap`` are byte-equal; ``draw_quads``, ``visualize_page``
(with and without ``show_order``) and ``create_collage`` on a synthetic page
with quads inside it are byte-equal to the JAX images, and each check allows
at most 1 grey level on at most 0.1 % of the values (a blurred mask value
one float32 step apart can truncate to the next grey level). Quads that
cross the page's edge are clipped as cv2 clips them; the border pixels
where ``fill_poly`` still differs from cv2 there are bounded below.

``vis=True`` through ``EAST.predict``/``predict_batch``,
``Pipeline.predict``/``process_batch`` on the fused and the classic route,
and the CLI's ``ocr --vis``/``detect --vis``, on the committed micro
checkpoints, float32, TF32 off: the same words as the JAX package (boxes
within 1e-2 px) and images within 1 grey level of its images.
"""

import json
import sys

import cv2
import numpy as np
import pytest
import torch

import manuscript_tpu_torch.__main__ as cli
from manuscript_tpu.detectors import EAST as JaxEAST
from manuscript_tpu.pipeline import Pipeline as JaxPipeline
from manuscript_tpu.types import Block as JBlock
from manuscript_tpu.types import Page as JPage
from manuscript_tpu.types import Word as JWord
from manuscript_tpu.utils import visualize as JV
from manuscript_tpu.utils.quality import QUALITY_DIR, load_quality_models
from manuscript_tpu.utils.synthetic import render_page
from manuscript_tpu_torch import Pipeline
from manuscript_tpu_torch.detectors import EAST
from manuscript_tpu_torch.ops.image import decode_png, encode_png, normalize_u8
from manuscript_tpu_torch.train.east_dataset import fill_poly
from manuscript_tpu_torch.types import Block, Page, Word
from manuscript_tpu_torch.utils import visualize as PV
from manuscript_tpu_torch.utils.quality import load_quality_models as port_models

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

META = json.loads((QUALITY_DIR / "east_micro.json").read_text())
EAST_SETTINGS = dict(
    backbone=META["backbone"], target_size=META["target_size"], score_thresh=META["score_thresh"],
    expand_ratio_w=META["expand_ratio"], expand_ratio_h=META["expand_ratio"],
    quantization=META["quantization"], max_candidates=2048, max_boxes=256,
)


def assert_close_images(got, ref, max_share=1e-3):
    """At most 1 grey level apart, on at most ``max_share`` of the values."""
    got, ref = np.asarray(got).astype(np.int16), np.asarray(ref).astype(np.int16)
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= max_share, (diff > 0).mean()


def page_and_quads(seed, n=14, h=300, w=400):
    rng = np.random.default_rng(seed)
    page = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    quads = []
    for _ in range(n):
        x, y = rng.uniform(2, w - 70), rng.uniform(2, h - 30)
        qw, qh = rng.uniform(10, 60), rng.uniform(5, 20)
        quads.append([x, y, x + qw, y + rng.uniform(-3, 3), x + qw, y + qh, x, y + qh])
    return page, np.array(quads, np.float32)


def pages_of(quads, types):
    P, B, W = types
    return P(blocks=[B(words=[W(polygon=q.reshape(4, 2).tolist(), detection_confidence=0.9)
                              for q in quads])])


# ---- the drawing functions -----------------------------------------------------------


@pytest.mark.parametrize("k", [3, 5, 7, 11, 13, 15, 31])
def test_gaussian_blur_is_cv2s(k):
    assert np.array_equal(PV.gaussian_kernel(k), cv2.getGaussianKernel(k, 0).astype(np.float32)[:, 0])
    rng = np.random.default_rng(k)
    mask = np.zeros((41, 57), np.float32)
    for _ in range(6):
        x, y = rng.integers(-5, 50, 2)
        mask[max(y, 0) : y + rng.integers(3, 15), max(x, 0) : x + rng.integers(3, 30)] = 1.0
    diff = np.abs(PV.gaussian_blur(mask, k) - cv2.GaussianBlur(mask, (k, k), 0))
    assert diff.max() <= (0.0 if k <= 7 else 1.2e-7), diff.max()


def test_jet_table_and_colormap_are_byte_equal():
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None], cv2.COLORMAP_JET)[:, 0, ::-1]
    np.testing.assert_array_equal(PV.JET_RGB, lut)
    m = np.random.default_rng(0).normal(size=(37, 53)).astype(np.float32)
    np.testing.assert_array_equal(PV._colormap(m), JV._colormap(m))
    np.testing.assert_array_equal(PV._colormap(np.zeros((4, 4), np.float32)),
                                  JV._colormap(np.zeros((4, 4), np.float32)))


@pytest.mark.parametrize("seed,thickness,ksize", [(0, 1, 11), (1, 2, 12), (2, 3, 7)])
def test_draw_quads_matches_jax(seed, thickness, ksize):
    page, quads = page_and_quads(seed)
    kw = dict(color=(255, 0, 0), thickness=thickness, dark_alpha=0.4, blur_ksize=ksize)
    assert_close_images(PV.draw_quads(page, quads, **kw), JV.draw_quads(page, quads, **kw))
    np.testing.assert_array_equal(np.asarray(PV.draw_quads(page, [])), page)


@pytest.mark.parametrize("show_order", [False, True])
def test_visualize_page_matches_jax(show_order):
    page, quads = page_and_quads(3)
    got = PV.visualize_page(page, pages_of(quads, (Page, Block, Word)), show_order=show_order)
    ref = JV.visualize_page(page, pages_of(quads, (JPage, JBlock, JWord)), show_order=show_order)
    assert got.size == ref.size == (page.shape[1], page.shape[0])
    assert_close_images(got, ref)
    empty = PV.visualize_page(page, Page(blocks=[Block(words=[])]))
    np.testing.assert_array_equal(np.asarray(empty), page)


@pytest.mark.parametrize("with_pred", [False, True])
def test_create_collage_matches_jax(with_pred):
    rng = np.random.default_rng(4)
    page, quads = page_and_quads(4, h=128, w=128)
    score = rng.random((32, 32)).astype(np.float32)
    geo = rng.normal(size=(32, 32, 8)).astype(np.float32)
    pred = dict(pred_score=score[::-1].copy(), pred_geo=geo * 2) if with_pred else {}
    got = PV.create_collage(page, score, geo, gt_quads=quads, **pred)
    ref = JV.create_collage(page, score, geo, gt_quads=quads, **pred)
    assert got.shape == (640, 3200, 3) and got.dtype == np.uint8
    assert_close_images(got, ref)


def test_quads_crossing_the_edge_are_clipped_as_cv2_clips_them():
    """cv2 clips an edge that leaves the image before it walks it, and so
    does fill_poly; on 2000 random rotated quads around the border it still
    sets other pixels than cv2 5.0 on 63 (3.2 %; bound 4 %), 6.3 border
    pixels each on average (bound 10): cv2's handling of an edge wholly
    outside the image is not reproduced (see east_dataset.py)."""
    rng = np.random.default_rng(2)
    differ, pixels = 0, 0
    for t in range(2000):
        x, y = rng.uniform(-30, 90), rng.uniform(-20, 70)
        w, h, a = rng.uniform(5, 60), rng.uniform(3, 25), np.radians(rng.uniform(-30, 30))
        rot = np.array([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]])
        pts = (np.array([[0, 0], [w, 0], [w, h], [0, h]]) @ rot + (x, y)).astype(np.int32)
        want = np.zeros((60, 80), np.uint8)
        cv2.fillPoly(want, [pts], 1)
        got = fill_poly(np.zeros((60, 80), np.uint8), pts, 1)
        differ += not np.array_equal(got, want)
        pixels += int((got != want).sum())
    assert differ <= 80 and pixels <= 10 * differ, (differ, pixels)


def test_the_numpy_core_needs_no_pil(monkeypatch):
    page, quads = page_and_quads(5)
    ref = PV.shade_quads(page, quads, dark_alpha=0.3)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(PV.shade_quads(page, quads, dark_alpha=0.3), ref)
    with pytest.raises(ImportError):
        PV.draw_quads(page, quads)
    far = np.ones(page.shape[:2], bool)  # 20 px from every quad: the page darkened
    for q in quads:
        x0, y0 = q.reshape(4, 2).min(0).astype(int) - 20
        x1, y1 = q.reshape(4, 2).max(0).astype(int) + 20
        far[max(y0, 0) : y1, max(x0, 0) : x1] = False
    np.testing.assert_array_equal(ref[far], (page[far].astype(np.float32) * 0.7).astype(np.uint8))


# ---- vis=True through the entry points -------------------------------------------------


@pytest.fixture(scope="module")
def pages():
    return [render_page(np.random.default_rng(s))[0] for s in (123, 321)]


@pytest.fixture(scope="module")
def detectors():
    import jax.numpy as jnp

    jdet = JaxEAST(weights_path=str(QUALITY_DIR / "east_micro.msgpack"), dtype=jnp.float32,
                   **EAST_SETTINGS)
    det = EAST(QUALITY_DIR / "east_micro.msgpack", device="cpu", dtype=torch.float32,
               **EAST_SETTINGS)
    return jdet, det


def _words(page):
    return [w for b in page.blocks for w in b.words]


def assert_same_pages(got, ref):
    gw, rw = _words(got), _words(ref)
    assert len(gw) == len(rw) > 0
    for a, b in zip(gw, rw):
        np.testing.assert_allclose(a.polygon, b.polygon, atol=1e-2, rtol=0)
        assert a.text == b.text


def test_east_predict_and_predict_batch_vis(detectors, pages):
    jdet, det = detectors
    got, ref = det.predict(pages[0], vis=True), jdet.predict(pages[0], vis=True)
    assert_same_pages(got["page"], ref["page"])
    assert_close_images(got["vis_image"], ref["vis_image"])
    got_b = det.predict_batch(pages, batch_size=2, vis=True)
    ref_b = jdet.predict_batch(pages, batch_size=2, vis=True)
    for g, r in zip(got_b, ref_b):
        assert_same_pages(g["page"], r["page"])
        assert_close_images(g["vis_image"], r["vis_image"])


@pytest.fixture(scope="module")
def pipelines():
    east, trba = load_quality_models()
    jax_fused = JaxPipeline(east, trba, fused=True, crop_source="native", max_words=32,
                            mode="greedy")
    jax_classic = JaxPipeline(east, trba, fused=False, mode="greedy")
    port = port_models("cpu")
    fused = Pipeline(*port, device="cpu", max_words=32, mode="greedy", batch_pages=2)
    classic = Pipeline(*port, device="cpu", fused=False, mode="greedy")
    return {"fused": (jax_fused, fused), "classic": (jax_classic, classic)}


@pytest.mark.parametrize("route", ["fused", "classic"])
def test_pipeline_predict_vis(pipelines, pages, route):
    jpipe, pipe = pipelines[route]
    (got, got_img), (ref, ref_img) = pipe.predict(pages[0], vis=True), jpipe.predict(pages[0], vis=True)
    assert_same_pages(got, ref)
    assert_close_images(got_img, ref_img)


@pytest.mark.parametrize("route", ["fused", "classic"])
def test_pipeline_process_batch_vis(pipelines, pages, route):
    jpipe, pipe = pipelines[route]
    got, ref = pipe.process_batch(pages, vis=True), jpipe.process_batch(pages, vis=True)
    assert len(got) == len(ref) == len(pages)
    for (gp, gi), (rp, ri) in zip(got, ref):
        assert_same_pages(gp, rp)
        assert_close_images(gi, ri)


def test_pipeline_detection_only_vis_has_no_numbers(pipelines, pages):
    jpipe, pipe = pipelines["classic"]
    (got, got_img), (ref, ref_img) = (p.predict(pages[1], recognize_text=False, vis=True)
                                      for p in (pipe, jpipe))
    assert_same_pages(got, ref)
    assert_close_images(got_img, ref_img)
    np.testing.assert_array_equal(  # unnumbered: visualize_page without show_order
        np.asarray(got_img), np.asarray(PV.visualize_page(pages[1], got, show_order=False)))


def test_cli_vis_writes_the_jax_packages_image(pipelines, detectors, pages, tmp_path, monkeypatch):
    path = tmp_path / "page.png"
    path.write_bytes(encode_png(pages[0]))
    port = port_models("cpu")
    monkeypatch.setattr("manuscript_tpu_torch.Pipeline",
                        lambda **kw: Pipeline(*port, device="cpu", **dict(kw, max_words=32)))
    cli.main(["ocr", str(path), "--vis", str(tmp_path / "ocr.png"), "--mode", "greedy"])
    _, ref = pipelines["fused"][0].predict(pages[0], vis=True)
    drawn = decode_png((tmp_path / "ocr.png").read_bytes())
    assert drawn.shape == pages[0].shape
    assert_close_images(drawn, ref)

    import manuscript_tpu_torch.detectors as d

    monkeypatch.setattr(d, "EAST", lambda **kw: detectors[1])
    cli.main(["detect", str(path), "--vis", str(tmp_path / "det.png")])
    ref = detectors[0].predict(pages[0], vis=True)["vis_image"]
    assert_close_images(decode_png((tmp_path / "det.png").read_bytes()), ref)


@pytest.mark.parametrize("cache_device", [False, True])
def test_east_trainer_logs_the_jax_packages_collage(tmp_path, monkeypatch, cache_device):
    """``EAST.train`` logs ``val/collage`` once a validation: sample 0 of the
    first validation batch (streamed: the host batch; GPU-resident: the
    dataset's item 0), its GT quads and the model's prediction, as the JAX
    trainer builds it (``create_collage``; within 1 grey level)."""
    import torch.utils.tensorboard as tb

    from manuscript_tpu_torch.train.east_dataset import EASTDataset
    from manuscript_tpu_torch.utils.synthetic import build_page_dataset

    images = []

    class Recorder:
        def __init__(self, log_dir):
            pass

        def add_image(self, tag, img, step, dataformats):
            images.append((tag, img, step, dataformats))

        def add_scalar(self, *args):
            pass

        def close(self):
            pass

    monkeypatch.setattr(tb, "SummaryWriter", Recorder)
    coco, img_dir, _ = build_page_dataset(tmp_path / "pages", 2, seed=0, page_h=256, page_w=192,
                                          n_rows=3, n_cols=1)
    out = EAST.train(img_dir, coco, img_dir, coco, experiment_root=str(tmp_path), epochs=1,
                     backbone="resnet50-micro", target_size=64, batch_size=2, use_multiscale=False,
                     cache_device=cache_device, device="cpu")
    assert [(t, s, f) for t, _, s, f in images] == [("val/collage", 0, "HWC")]
    im0, sc0, geo0, quads0 = EASTDataset(img_dir, coco, target_size=64, augment=False)[0]
    model = out["model"].eval()
    with torch.no_grad():
        pred = model(normalize_u8(torch.from_numpy(im0)[None]))
    ref = JV.create_collage(im0, sc0, geo0, gt_quads=quads0, pred_score=pred["score"][0, ..., 0].numpy(),
                            pred_geo=pred["geometry"][0].numpy())
    assert_close_images(images[0][1], ref)
