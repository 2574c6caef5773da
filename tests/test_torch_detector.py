"""The port's ``EAST.predict``/``predict_batch`` against the JAX package's
EAST with the same micro checkpoint, float32, TF32 off, on the CPU.

Both packages run the network in float32 on the CPU and differ only in the
order of their sums (maps within 1e-4), so each page must give the same
number of boxes, with polygons within 1e-2 px and detection confidences
within 1e-4, through the host LANMS (``nms="host"``) and through the scan
LANMS on the device (``nms="device"``)."""

import json

import numpy as np
import pytest
import torch

from manuscript_tpu.detectors import EAST as JaxEAST
from manuscript_tpu.utils.quality import QUALITY_DIR
from manuscript_tpu_torch.detectors import EAST
from manuscript_tpu_torch.utils.synthetic import render_page

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

META = json.loads((QUALITY_DIR / "east_micro.json").read_text())
SETTINGS = dict(
    backbone=META["backbone"], target_size=META["target_size"], score_thresh=META["score_thresh"],
    expand_ratio_w=META["expand_ratio"], expand_ratio_h=META["expand_ratio"],
    quantization=META["quantization"], max_candidates=2048, max_boxes=256,
)


def jax_east(nms):
    import jax.numpy as jnp

    return JaxEAST(weights_path=str(QUALITY_DIR / "east_micro.msgpack"), nms=nms,
                   dtype=jnp.float32, **SETTINGS)


def port_east(nms):
    return EAST(QUALITY_DIR / "east_micro.msgpack", device="cpu", nms=nms,
                dtype=torch.float32, **SETTINGS)


@pytest.fixture(scope="module")
def hosts():
    return jax_east("host"), port_east("host")


@pytest.fixture(scope="module")
def pages():
    return [render_page(np.random.default_rng(s))[0] for s in (9000, 9100, 9200)]


def words(res):
    return [w for b in res["page"].blocks for w in b.words]


def assert_same_words(got, ref):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.polygon, b.polygon, atol=1e-2, rtol=0)
        assert a.detection_confidence == pytest.approx(b.detection_confidence, abs=1e-4)


@pytest.mark.parametrize("sort_reading_order", [False, True])
def test_predict_host_nms_matches_jax(hosts, pages, sort_reading_order):
    jax_det, det = hosts
    got = det.predict(pages[0], sort_reading_order=sort_reading_order)
    ref = jax_det.predict(pages[0], sort_reading_order=sort_reading_order)
    assert set(got) == {"page", "vis_image", "score_map", "geo_map"}
    assert got["vis_image"] is None and got["score_map"] is None and got["geo_map"] is None
    assert_same_words(words(got), words(ref))
    assert set(det.last_timings) == {"prep", "forward", "fetch", "lanms", "boxes"}


def test_predict_return_maps_matches_jax(hosts, pages):
    jax_det, det = hosts
    got, ref = det.predict(pages[1], return_maps=True), jax_det.predict(pages[1], return_maps=True)
    h = META["target_size"] // 4
    assert got["score_map"].shape == (h, h) and got["geo_map"].shape == (8, h, h)
    np.testing.assert_allclose(got["score_map"], ref["score_map"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["geo_map"], ref["geo_map"], atol=1e-3, rtol=0)
    assert_same_words(words(got), words(ref))


def test_predict_device_nms_matches_jax(pages):
    """The scan LANMS and the device post-processing: the JAX package's
    device program, and within the JAX package's own host/device check of
    the host path (rtol 1e-2, atol 0.5 on sorted polygons)."""
    jax_det, det = jax_east("device"), port_east("device")
    got, ref = words(det.predict(pages[2])), words(jax_det.predict(pages[2]))
    assert_same_words(got, ref)
    host = words(port_east("host").predict(pages[2]))
    assert len(host) == len(got)
    ph = np.sort(np.array([w.polygon for w in host]).reshape(len(host), -1), 0)
    pd = np.sort(np.array([w.polygon for w in got]).reshape(len(got), -1), 0)
    np.testing.assert_allclose(ph, pd, rtol=1e-2, atol=0.5)


@pytest.mark.parametrize("batch_size,n_pages", [(1, 2), (2, 3)])
def test_predict_batch_matches_jax(hosts, pages, batch_size, n_pages):
    """One page at a time, and chunks of 2 with a short last chunk (the JAX
    package pads it; the port does not)."""
    jax_det, det = hosts
    got = det.predict_batch(pages[:n_pages], batch_size=batch_size)
    ref = jax_det.predict_batch(pages[:n_pages], batch_size=batch_size)
    assert len(got) == len(ref) == n_pages
    for g, r in zip(got, ref):
        assert_same_words(words(g), words(r))
    single = words(det.predict(pages[n_pages - 1]))
    assert [w.polygon for w in words(got[-1])] == [w.polygon for w in single]


def test_detector_refusals(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="nms"):
        port_east("banana")
    with pytest.raises(FileNotFoundError):
        EAST(tmp_path / "missing.msgpack", device="cpu")
    det = EAST(device="cpu", target_size=64, backbone="resnet50-micro", allow_random_init=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        det.predict(np.zeros((32, 32, 3), np.uint8), vis=True)
    with pytest.raises(FileNotFoundError):
        det.predict(str(tmp_path / "missing.png"))
    with pytest.raises(TypeError):
        det.predict(12345)


def test_weights_from_cache_and_environment(tmp_path, monkeypatch):
    """No weights_path: the first checkpoint under ~/.manuscript_tpu/east;
    with none there, random weights only when the environment allows."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("MANUSCRIPT_TPU_ALLOW_RANDOM_INIT", raising=False)
    with pytest.raises(ValueError, match="MANUSCRIPT_TPU_ALLOW_RANDOM_INIT"):
        EAST(device="cpu", backbone="resnet50-micro")
    monkeypatch.setenv("MANUSCRIPT_TPU_ALLOW_RANDOM_INIT", "1")
    assert EAST(device="cpu", backbone="resnet50-micro").weights_path is None
    cache = tmp_path / ".manuscript_tpu" / "east" / "v1"
    cache.mkdir(parents=True)
    (cache / "east.msgpack").write_bytes((QUALITY_DIR / "east_micro.msgpack").read_bytes())
    det = EAST(device="cpu", backbone=META["backbone"])
    assert det.weights_path == cache / "east.msgpack"
