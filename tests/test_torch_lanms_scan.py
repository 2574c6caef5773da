"""The port's scan LANMS (``ops/lanms_torch.locality_aware_nms``: the merge
walk's plain twin of kernel K3, then ``_standard_nms``) against the JAX
package's ``locality_aware_nms_jax`` on the CPU.

Counts are held to equality, the boxes and scores to 1e-3: both are float32,
and XLA may contract the weighted merge's multiply-adds where torch rounds
each operation (coordinates up to 800 px, so 1e-3 is a few ulps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manuscript_tpu.ops.lanms_jax import locality_aware_nms_jax
from manuscript_tpu_torch.ops import lanms_torch as tl

TOL = 1e-3


def field(rng, n, words=25, pad=0, size=800.0, sigma=2.0):
    c = rng.uniform(0, size, (words, 2))
    wh = np.stack([rng.uniform(40, 160, words), rng.uniform(15, 40, words)], 1)
    base = np.concatenate([c - wh / 2, c + [1, -1] * wh / 2, c + wh / 2, c + [-1, 1] * wh / 2], 1)
    rows = base[rng.integers(0, words, n)] + rng.normal(0, sigma, (n, 8))
    rows = np.concatenate([rows, rng.uniform(0.5, 1, (n, 1))], 1)
    rows = np.concatenate([rows, np.full((pad, 9), -1.0)])
    return rows[rng.permutation(len(rows))].astype(np.float32)


def check_against_jax(cands: np.ndarray, max_out: int, thresh: float = 0.2):
    ref, n_ref = locality_aware_nms_jax(jnp.asarray(cands), jnp.float32(thresh), max_out=max_out)
    got, n_got = tl.locality_aware_nms(torch.from_numpy(cands), thresh, max_out)
    assert got.shape == (max_out, 9)
    assert int(n_got) == int(n_ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    return got.numpy(), int(n_got)


@pytest.mark.parametrize("n,pad,words", [(180, 60, 25), (300, 0, 40)])
def test_scan_lanms_matches_jax_with_padding_rows(n, pad, words):
    boxes, count = check_against_jax(field(np.random.default_rng(n), n, words, pad), 64)
    assert 0.6 * words <= count <= words
    assert (boxes[count:] == 0).all()


def test_scan_lanms_x0_ties_keep_input_order():
    """Rows with equal x0 are walked in their input order (stable sort), so
    which one opens a merged quad, and the order of the merge, follow it."""
    rng = np.random.default_rng(1)
    cands = field(rng, 120, words=12)
    cands[::3, 0] = np.round(cands[::3, 0] / 40) * 40  # many exact x0 ties
    cands[::3, 6] = cands[::3, 0]
    check_against_jax(cands, 32)


@pytest.mark.parametrize("max_out", [1, 4])
def test_scan_lanms_max_out_overflow(max_out):
    """More merged quads than ``max_out``: every quad past it lands in the
    last slot (the reference's clamp), and the count says so."""
    cands = field(np.random.default_rng(2), 150, words=30)
    rows = torch.from_numpy(cands)[None]
    key = torch.where(rows[..., 8] >= 0, rows[..., 0], torch.full_like(rows[..., 0], float("inf")))
    sorted_rows = rows[:, torch.sort(key, dim=1, stable=True).indices[0]].contiguous()
    _, _, count = tl.lanms_merge_scan_plain(sorted_rows, 0.2, max_out)
    assert int(count[0]) > max_out
    _, n = check_against_jax(cands, max_out)
    assert 1 <= n <= max_out


def test_scan_lanms_empty_and_single():
    check_against_jax(np.full((16, 9), -1.0, np.float32), 8)  # padding only
    _, n = check_against_jax(np.zeros((0, 9), np.float32), 8)
    assert n == 0
    one = np.array([[10, 10, 60, 10, 60, 30, 10, 30, 0.9]], np.float32)
    boxes, n = check_against_jax(np.concatenate([one, np.full((5, 9), -1.0, np.float32)]), 8)
    assert n == 1 and np.array_equal(boxes[0], one[0])


def test_scan_lanms_pages_are_independent():
    """With a leading page axis each page gives what it gives alone."""
    rng = np.random.default_rng(4)
    pages = np.stack([field(rng, 90, words=10, pad=30), field(rng, 120, words=15)])
    got, n = tl.locality_aware_nms(torch.from_numpy(pages), 0.2, 32)
    for i in range(2):
        one, n_one = tl.locality_aware_nms(torch.from_numpy(pages[i]), 0.2, 32)
        assert int(n[i]) == int(n_one)
        np.testing.assert_array_equal(got[i].numpy(), one.numpy())


def test_merge_scan_cpu_route_and_counter():
    """On CPU tensors the wrapper runs the plain twin and launches nothing."""
    rows = torch.from_numpy(field(np.random.default_rng(5), 40, words=5))[None]
    before = tl.launches
    a = tl.lanms_merge_scan(rows, 0.2, 8)
    b = tl.lanms_merge_scan_plain(rows, 0.2, 8)
    assert tl.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="not CUDA"):
        tl.lanms_merge_scan_cuda(rows, 0.2, 8)
