"""The port's host box operations and host decode against the JAX package's
on the CPU: the same float64/float32 numpy code, so every output is held to
exact equality."""

import numpy as np
import pytest

from manuscript_tpu.ops import boxes as jb
from manuscript_tpu.ops import decode as jd
from manuscript_tpu_torch import detectors as tdet
from manuscript_tpu_torch.ops import boxes as tb
from manuscript_tpu_torch.ops import decode as td


def quads(rng, n, size=500.0):
    """Rotated boxes (n, 9), a few nested inside others and a few huge."""
    c = rng.uniform(0, size, (n, 2))
    w, h = rng.uniform(10, 80, n), rng.uniform(5, 30, n)
    th = rng.uniform(-0.4, 0.4, n)
    local = np.stack([[-w, -h], [w, -h], [w, h], [-w, h]], 0).transpose(2, 0, 1) / 2
    rot = np.stack([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]).transpose(2, 0, 1)
    q = local @ rot.transpose(0, 2, 1) + c[:, None]
    q[: n // 5] = q[n // 5 : 2 * (n // 5)].mean(1, keepdims=True) + 0.3 * (
        q[n // 5 : 2 * (n // 5)] - q[n // 5 : 2 * (n // 5)].mean(1, keepdims=True))  # nested
    q[-2:] *= 3.0  # area anomalies
    return np.concatenate([q.reshape(n, 8), rng.uniform(0, 1, (n, 1))], 1).astype(np.float32)


@pytest.mark.parametrize("n", [0, 1, 40, 300])
def test_box_chain_ops_match_jax(n):
    rng = np.random.default_rng(n)
    q = quads(rng, n)
    for ew, eh in ((0.0, 0.0), (0.9, 0.9), (0.52, 0.3)):
        np.testing.assert_array_equal(tb.expand_boxes(q, ew, eh), jb.expand_boxes(q, ew, eh))
    np.testing.assert_array_equal(tb.scale_boxes(q, 1280, 1600, 1200), jb.scale_boxes(q, 1280, 1600, 1200))
    np.testing.assert_array_equal(tb.to_axis_aligned(q), jb.to_axis_aligned(q))
    got = tb.remove_fully_contained(q)
    np.testing.assert_array_equal(got, jb.remove_fully_contained(q))
    if n >= 40:
        assert len(got) < n  # the nested boxes went
    for sigma, min_count in ((5.0, 30), (1.0, 10), (1.0, 400)):
        np.testing.assert_array_equal(tb.remove_area_anomalies(q, sigma, min_count),
                                      jb.remove_area_anomalies(q, sigma, min_count))


def test_remove_fully_contained_is_order_free():
    q = quads(np.random.default_rng(5), 120)
    perm = np.random.default_rng(6).permutation(len(q))
    a = tb.remove_fully_contained(q)
    b = tb.remove_fully_contained(q[perm])
    assert sorted(map(bytes, a)) == sorted(map(bytes, b))


def test_compact_topk_matches_jax():
    rng = np.random.default_rng(3)
    cands = rng.uniform(0, 100, (64, 9)).astype(np.float32)
    cands[rng.uniform(size=64) < 0.4, 8] = -1.0
    got = td.compact_topk(cands)
    np.testing.assert_array_equal(got, jd.compact_topk(cands))
    assert got.dtype == np.float32 and (got[:, 8] >= 0).all()
    assert td.compact_topk(np.full((8, 9), -1.0)).shape == (0, 9)


@pytest.mark.parametrize("q", [1, 2, 3])
def test_decode_quads_numpy_matches_jax(q):
    rng = np.random.default_rng(q)
    score = rng.uniform(0, 1, (37, 29)).astype(np.float32)
    geo = rng.normal(0, 5, (37, 29, 8)).astype(np.float32)
    for thresh in (0.5, 0.9, 1.5):
        got = td.decode_quads_numpy(score, geo, thresh, 4.0, quantization=q)
        np.testing.assert_array_equal(got, jd.decode_quads_numpy(score, geo, thresh, 4.0, quantization=q))
        np.testing.assert_array_equal(td.decode_quads_numpy(score[None], geo, thresh, 4.0, q), got)
    assert td.decode_quads_numpy(np.zeros((8, 8), np.float32), geo[:8, :8], 0.5, 4.0).shape == (0, 9)
    assert tdet.decode_quads_from_maps is td.decode_quads_numpy
