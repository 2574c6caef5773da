"""Phase A on a chunk of pages: the port's decode, compaction, LANMS and box
post-processing with a leading page axis, on B = 3 pages, against per-page
calls of the same functions (equal) and against ``jax.vmap`` of the JAX
package's functions (equal validity and counts, boxes within 1e-3 px). Also
the quad-IoU twin's per-page live counts, with a page whose candidate pairs
overflow its 16·M slots."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manuscript_tpu.ops.decode import compact_candidates as j_compact, decode_cells_jax
from manuscript_tpu.ops.lanms_jax import _standard_nms as j_nms
from manuscript_tpu.ops.lanms_jax import locality_aware_nms_parallel as j_lanms
from manuscript_tpu.ops.postprocess_jax import postprocess_boxes_jax
from manuscript_tpu_torch.ops.decode import compact_candidates, decode_cells
from manuscript_tpu_torch.ops.lanms_torch import _standard_nms, locality_aware_nms_parallel
from manuscript_tpu_torch.ops.postprocess_torch import postprocess_boxes
from manuscript_tpu_torch.ops.quad_iou import quad_iou_gather, quad_iou_gather_plain

POST = dict(axis_aligned=True, remove_anomalies=True, anomaly_sigma=5.0, anomaly_min_count=3)


def word_maps(rng, size=64, n_words=7):
    """Score/geometry maps with word blobs whose pixels all point at one
    jittered rectangle, so neighbouring candidates are near-duplicates."""
    score = rng.uniform(0.0, 0.3, (size, size)).astype(np.float32)
    geo = rng.normal(0, 0.3, (size, size, 8)).astype(np.float32)
    ys, xs = np.mgrid[0:size, 0:size]
    for _ in range(n_words):
        x0, y0 = rng.uniform(2, size - 20), rng.uniform(2, size - 8)
        w, h = rng.uniform(6, 16), rng.uniform(2, 5)
        m = (xs >= x0) & (xs < x0 + w) & (ys >= y0) & (ys < y0 + h)
        score[m] = rng.uniform(0.7, 1.0, m.sum())
        corners = np.array([x0, y0, x0 + w, y0, x0 + w, y0 + h, x0, y0 + h])
        off = corners[None, :] - np.stack([xs[m], ys[m]] * 4, 1)
        geo[m] = off + rng.normal(0, 0.2, off.shape)
    return score, geo


def chunk_maps(seed):
    rng = np.random.default_rng(seed)
    maps = [word_maps(rng, n_words=n) for n in (7, 3, 12)]
    return np.stack([m[0] for m in maps]), np.stack([m[1] for m in maps])


@pytest.mark.parametrize("seed,q,max_cands,max_boxes", [(0, 1, 512, 64), (1, 2, 512, 64), (2, 1, 128, 32)])
def test_batched_phase_a_equals_pages_and_jax_vmap(seed, q, max_cands, max_boxes):
    score, geo = chunk_maps(seed)
    thresh = np.array([0.6, 0.65, 0.6], np.float32)
    iou, scale = 0.2, 4.0
    sx, sy = np.array([1.3, 0.9, 1.0], np.float32), np.array([0.9, 1.1, 1.0], np.float32)

    tq, ts, tv = decode_cells(torch.from_numpy(score), torch.from_numpy(geo),
                              torch.from_numpy(thresh), q, scale)
    tc = compact_candidates(tq, ts, tv, max_cands)
    tm, tn = locality_aware_nms_parallel(tc, iou, max_boxes)
    tb, tval = postprocess_boxes(tm, tn, 0.52, 0.52, torch.from_numpy(sx), torch.from_numpy(sy), **POST)
    assert tuple(tb.shape) == (3, max_boxes, 9) and tn.min() > 0

    for i in range(3):  # each page on its own: equal
        pq, ps, pv = decode_cells(torch.from_numpy(score[i]), torch.from_numpy(geo[i]),
                                  float(thresh[i]), q, scale)
        pc = compact_candidates(pq, ps, pv, max_cands)
        assert torch.equal(pc, tc[i])
        pm, pn = locality_aware_nms_parallel(pc, iou, max_boxes)
        assert torch.equal(pm, tm[i]) and int(pn) == int(tn[i])
        pb, pval = postprocess_boxes(pm, pn, 0.52, 0.52, float(sx[i]), float(sy[i]), **POST)
        assert torch.equal(pb, tb[i]) and torch.equal(pval, tval[i])

    jq, js, jv = jax.vmap(lambda s, g, t: decode_cells_jax(s, g, t, quantization=q, scale=scale))(
        jnp.asarray(score), jnp.asarray(geo), jnp.asarray(thresh))
    jc = jax.vmap(lambda a, b, c: j_compact(a, b, c, max_cands))(jq, js, jv)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, rtol=0)
    jm, jn = jax.vmap(lambda c: j_lanms(c, jnp.float32(iou), max_out=max_boxes))(jc)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-3, rtol=0)
    jb, jval = jax.vmap(lambda m, n, a, b: postprocess_boxes_jax(m, n, 0.52, 0.52, a, b, **POST))(
        jm, jn, jnp.asarray(sx), jnp.asarray(sy))
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-3, rtol=0)


def test_batched_nms_keeps_each_pages_pair_capacity():
    """Page 1 holds 40 identical boxes: 780 candidate pairs against 16·40 =
    640 slots, so its overflow pairs keep the upper bound's decision; pages 0
    and 2 stay within their own slots. The chunk equals its pages and the
    JAX package's vmap."""
    rng = np.random.default_rng(7)
    m = 40
    quads = np.zeros((3, m, 4, 2), np.float32)
    for b in (0, 2):
        x, y = rng.uniform(0, 200, m), rng.uniform(0, 200, m)
        w, h = rng.uniform(10, 30, m), rng.uniform(4, 10, m)
        quads[b] = np.stack([np.stack([x, y], 1), np.stack([x + w, y], 1),
                             np.stack([x + w, y + h], 1), np.stack([x, y + h], 1)], 1)
    quads[1] = np.array([[0, 0], [10, 0], [10, 4], [0, 4]], np.float32)
    quads[1, :, 0, 0] += np.arange(m, dtype=np.float32) * 1e-3
    scores = rng.uniform(0.5, 1.0, (3, m)).astype(np.float32)
    valid = np.ones((3, m), bool)
    valid[2, 30:] = False

    tb, tn = _standard_nms(torch.from_numpy(quads), torch.from_numpy(scores),
                           torch.from_numpy(valid), 0.2)
    assert int(tn[1]) == 1
    for i in range(3):
        pb, pn = _standard_nms(torch.from_numpy(quads[i]), torch.from_numpy(scores[i]),
                               torch.from_numpy(valid[i]), 0.2)
        assert torch.equal(pb, tb[i]) and int(pn) == int(tn[i])
    jb, jn = jax.vmap(lambda q, s, v: j_nms(q, s, v, 0.2, jnp.float32))(
        jnp.asarray(quads), jnp.asarray(scores), jnp.asarray(valid))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)


def test_quad_iou_gather_per_page_live_counts():
    rng = np.random.default_rng(3)
    quads = torch.from_numpy(rng.uniform(0, 50, (90, 4, 2)).astype(np.float32))
    ia = torch.from_numpy(rng.integers(0, 90, 4 * 64).astype(np.int32))
    ib = torch.from_numpy(rng.integers(0, 90, 4 * 64).astype(np.int32))
    n_live = torch.tensor([64, 0, 17, 63], dtype=torch.int32)
    got = quad_iou_gather(quads, ia, ib, n_live).reshape(4, 64)
    full = quad_iou_gather_plain(quads, ia, ib).reshape(4, 64)
    for b, n in enumerate(n_live.tolist()):
        assert torch.equal(got[b, :n], full[b, :n])
        assert torch.all(got[b, n:] == 0)
    # a 0-d count is one page of all P slots
    one = quad_iou_gather(quads, ia, ib, torch.tensor(100, dtype=torch.int32))
    assert torch.equal(one[:100], full.reshape(-1)[:100]) and torch.all(one[100:] == 0)
    with pytest.raises(ValueError, match="pages"):
        quad_iou_gather(quads, ia, ib, torch.zeros(3, dtype=torch.int32))  # 256 % 3
