"""The port's host LANMS against the JAX package's on the CPU.

* ``csrc/lanms.cpp``, built here with the host C++ compiler, gives the bits of
  the JAX package's ``_liblanms.so`` (exact equality, up to 8192 rows) and
  the rows of the port's numpy twin (exact equality);
* ``standard_nms``, ``locality_aware_nms_numpy`` and the geometry helpers
  equal the JAX package's (exact equality: the same float64 numpy code);
* without a host compiler the build raises (it does not skip).
"""

import numpy as np
import pytest

from manuscript_tpu.ops import geometry as jg
from manuscript_tpu.ops import lanms as jl
from manuscript_tpu_torch.ops import _build
from manuscript_tpu_torch.ops import geometry as tg
from manuscript_tpu_torch.ops import lanms as tl


def jittered_field(rng, n, words=60, size=1200.0, sigma=2.0):
    """``n`` candidates: jittered copies of ``words`` word boxes, scores in
    [0.5, 1), in random order (as the detector's raster order leaves them)."""
    c = rng.uniform(0, size, (words, 2))
    wh = np.stack([rng.uniform(40, 160, words), rng.uniform(15, 40, words)], 1)
    base = np.concatenate([c - wh / 2, c + [1, -1] * wh / 2, c + wh / 2, c + [-1, 1] * wh / 2], 1)
    rows = base[rng.integers(0, words, n)] + rng.normal(0, sigma, (n, 8))
    return np.concatenate([rows, rng.uniform(0.5, 1, (n, 1))], 1).astype(np.float32)


@pytest.mark.parametrize("n", [0, 1, 2, 64, 1024, 8192])
def test_native_lanms_is_bit_equal_to_jax(n):
    rows = jittered_field(np.random.default_rng(n), n)
    got = tl.locality_aware_nms(rows, 0.2)
    ref = jl.locality_aware_nms_native(rows, 0.2)
    assert got.dtype == ref.dtype == np.float32
    assert got.shape == ref.shape and got.tobytes() == ref.tobytes()
    if n >= 1024:
        assert 40 <= len(got) <= 60  # one box per word, a few merged neighbours


@pytest.mark.parametrize("n,thresh", [(300, 0.2), (800, 0.5), (2048, 0.1)])
def test_native_lanms_equals_the_numpy_twin(n, thresh):
    rows = jittered_field(np.random.default_rng(n + 1), n, words=20)
    np.testing.assert_array_equal(
        tl.locality_aware_nms(rows, thresh), tl.locality_aware_nms_numpy(rows, thresh)
    )
    np.testing.assert_array_equal(
        tl.locality_aware_nms_numpy(rows, thresh), jl.locality_aware_nms_numpy(rows, thresh)
    )


def test_native_lanms_ties_and_identical_rows():
    """x0 ties keep the input order (stable sort), identical rows merge."""
    q = np.array([10, 10, 60, 10, 60, 30, 10, 30], np.float32)
    rows = np.array([[*q, 0.9], [*q, 0.7], [*(q + 1), 0.8], [*(q + 200), 0.6]], np.float32)
    rows[2, 0] = 10  # an x0 tie
    got = tl.locality_aware_nms(rows, 0.2)
    assert got.tobytes() == jl.locality_aware_nms_native(rows, 0.2).tobytes()
    assert len(got) == 2


def test_standard_nms_matches_jax():
    rng = np.random.default_rng(7)
    rows = jittered_field(rng, 200, words=15, sigma=6.0)
    polys, scores = rows[:, :8].reshape(-1, 4, 2), rows[:, 8]
    for thresh in (0.1, 0.3, 0.6):
        got, ref = tl.standard_nms(polys, scores, thresh), jl.standard_nms(polys, scores, thresh)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        assert 0 < len(got[0]) < 200
    empty = tl.standard_nms(np.zeros((0, 4, 2)), np.zeros(0), 0.2)
    assert empty[0].shape == (0, 4, 2) and empty[1].shape == (0,)


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(11)
    for _ in range(50):
        a = rng.uniform(0, 100, (4, 2))
        b = a[rng.permutation(4)] + rng.normal(0, 5, (4, 2))
        np.testing.assert_array_equal(tg.normalize_polygon(a, b), jg.normalize_polygon(a, b))
        for t in (0.0, 0.3):
            assert tg.should_merge(a, b, t) == jg.should_merge(a, b, t)
    # forward orders win ties: a square against itself rotated by 90°
    sq = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    np.testing.assert_array_equal(tg.normalize_polygon(sq, sq), sq)
    polys = rng.uniform(0, 50, (30, 4, 2))
    np.testing.assert_array_equal(tg.polygon_area_batch(polys), jg.polygon_area_batch(polys))
    assert tg.polygon_area_batch(np.zeros((0, 4, 2))).shape == (0,)
    pts = rng.uniform(-10, 60, (200, 2))
    for poly in (sq * 50, sq[::-1] * 50, polys[0]):
        np.testing.assert_array_equal(tg.point_in_polygon(pts, poly), jg.point_in_polygon(pts, poly))
    assert tg.point_in_polygon(np.array([[25.0, 25.0], [50.0, 10.0], [51.0, 10.0]]), sq * 50).tolist() == [
        True, True, False]


def test_missing_host_compiler_raises(monkeypatch, tmp_path):
    """No c++/g++ and no built library: the LANMS raises, it never falls
    back to numpy."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_libs", {})
    rows = jittered_field(np.random.default_rng(0), 10)
    with pytest.raises(RuntimeError, match="host C\\+\\+ compiler"):
        tl.locality_aware_nms(rows, 0.2)
    with pytest.raises(RuntimeError, match="host C\\+\\+ compiler"):
        _build.build(["lanms"])


def test_host_build_flags_and_path():
    assert _build._flags("lanms") == ["-O3", "-std=c++17", "-fPIC", "-shared"]
    assert _build._source("lanms").suffix == ".cpp"
    path = _build.library_path("lanms")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("liblanms-")
