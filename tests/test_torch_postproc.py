"""Phase A post-processing of the port against the JAX package on the CPU:
the same score and geometry maps through cell decode, candidate compaction,
the parallel LANMS (with its quad-IoU calls) and the box post-processing.
Candidates equal, counts and validity equal, boxes within 1e-3 px."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manuscript_tpu.ops.decode import compact_candidates as j_compact, decode_cells_jax
from manuscript_tpu.ops.lanms_jax import locality_aware_nms_parallel as j_lanms
from manuscript_tpu.ops.postprocess_jax import postprocess_boxes_jax
from manuscript_tpu_torch.ops.decode import compact_candidates, decode_cells
from manuscript_tpu_torch.ops.lanms_torch import locality_aware_nms_parallel
from manuscript_tpu_torch.ops.postprocess_torch import postprocess_boxes


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


@pytest.mark.parametrize("seed,q,max_cands,max_boxes", [
    (0, 1, 512, 64), (1, 2, 512, 64), (2, 1, 128, 32),  # 128: over capacity
])
def test_phase_a_postprocessing_matches_jax(seed, q, max_cands, max_boxes):
    rng = np.random.default_rng(seed)
    score, geo = word_maps(rng)
    thresh, iou, scale, sx, sy = 0.6, 0.2, 4.0, 1.3, 0.9

    jq, js, jv = decode_cells_jax(jnp.asarray(score), jnp.asarray(geo), thresh,
                                  quantization=q, scale=scale)
    jc = j_compact(jq, js, jv, max_cands)
    tq, ts, tv = decode_cells(torch.from_numpy(score), torch.from_numpy(geo), thresh, q, scale)
    tc = compact_candidates(tq, ts, tv, max_cands)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, rtol=0)

    jm, jn = j_lanms(jc, jnp.float32(iou), max_out=max_boxes)
    tm, tn = locality_aware_nms_parallel(torch.from_numpy(np.array(jc)), iou, max_boxes)
    assert int(tn) == int(jn) > 0
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-3, rtol=0)

    kw = dict(axis_aligned=True, remove_anomalies=True, anomaly_sigma=5.0, anomaly_min_count=3)
    jb, jval = postprocess_boxes_jax(jm, jn, 0.52, 0.52, jnp.float32(sx), jnp.float32(sy), **kw)
    tb, tval = postprocess_boxes(torch.from_numpy(np.array(jm)), torch.tensor(int(jn)),
                                 0.52, 0.52, sx, sy, **kw)
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-3, rtol=0)


def test_compaction_over_capacity_drops_the_raster_tail():
    rng = np.random.default_rng(4)
    quads = torch.from_numpy(rng.normal(size=(6, 5, 8)).astype(np.float32))
    scores = torch.rand(6, 5)
    valid = torch.ones(6, 5, dtype=torch.bool)
    out = compact_candidates(quads, scores, valid, 12)
    np.testing.assert_array_equal(out[:, :8].numpy(), quads.reshape(-1, 8)[:12].numpy())


def test_nms_pair_overflow_keeps_the_upper_bound():
    """40 identical boxes give 780 candidate pairs, over the 16·M = 640
    capacity at M = 40: the overflow pairs keep the bound's decision, and
    the JAX package's result is matched."""
    box = np.array([0, 0, 10, 0, 10, 4, 0, 4, 0.9], np.float32)
    cands = np.tile(box, (40, 1))
    cands[:, 0] += np.arange(40, dtype=np.float32) * 1e-3
    cands[:, 8] -= np.arange(40, dtype=np.float32) * 1e-3
    from manuscript_tpu.ops.lanms_jax import _standard_nms as j_nms
    from manuscript_tpu_torch.ops.lanms_torch import _standard_nms

    quads = cands[:, :8].reshape(40, 4, 2)
    valid = np.ones(40, bool)
    jb, jn = j_nms(jnp.asarray(quads), jnp.asarray(cands[:, 8]), jnp.asarray(valid), 0.2, jnp.float32)
    tb, tn = _standard_nms(torch.from_numpy(quads), torch.from_numpy(cands[:, 8]),
                           torch.from_numpy(valid), 0.2)
    assert int(tn) == int(jn) == 1
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)
