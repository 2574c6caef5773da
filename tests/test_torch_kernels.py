"""The port's two kernel modules against the JAX package, on the CPU.

On CPU tensors the wrappers run their plain torch versions; these tests hold
those against the XLA formulations the JAX main path calls —
``AttentionDecoder._cell`` for the decode step (its encoder memory repeated
across the beam, where the port takes one row per word) and
``quad_iou_pairs`` / ``quad_iou_matrix`` for the quad IoU, on gathered pairs
too — at atol 2e-5 (float32 sums taken in
another order). The CUDA kernels themselves are held against the same plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from manuscript_tpu.models.attention import AttentionDecoder
from manuscript_tpu.ops.lanms_jax import quad_iou_matrix, quad_iou_pairs
from manuscript_tpu_torch.ops import _build
from manuscript_tpu_torch.ops import attention_step as k1
from manuscript_tpu_torch.ops import quad_iou as k2

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("b,t,h,v", [(5, 8, 32, 20), (16, 32, 64, 50)])
def test_attention_step_plain_matches_cell(b, t, h, v, k):
    """The port takes one row of encoder memory per word and B·k beam rows;
    the JAX cell gets the memory repeated k times, as its beam search makes it."""
    rng = np.random.default_rng(b)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    dec = AttentionDecoder(enc_dim=h, hidden_size=h, num_classes=v)
    params = {
        "i2h_kernel": f(h, h, sc=h**-0.5), "h2h_kernel": f(h, h, sc=h**-0.5),
        "h2h_bias": f(h, sc=0.1), "score_kernel": f(h, 1, sc=h**-0.5),
        "lstm_kernel_ih": f(h + v, 4 * h, sc=h**-0.5),
        "lstm_kernel_hh": f(h, 4 * h, sc=h**-0.5), "lstm_bias": f(4 * h, sc=0.1),
        "gen_kernel": f(h, v, sc=h**-0.5), "gen_bias": f(v, sc=0.1),
    }
    enc, proj = f(b, t, h), f(b, t, h)
    hs, cs = f(b * k, h, sc=0.5), f(b * k, h, sc=0.5)
    tok = rng.integers(0, v, b * k)
    onehot = np.eye(v, dtype=np.float32)[tok]
    h_ref, c_ref, _ = dec.apply(
        {"params": params}, hs, cs, np.repeat(enc, k, 0), np.repeat(proj, k, 0), onehot,
        method=AttentionDecoder._cell,
    )
    T = torch.from_numpy
    h_got, c_got = k1.attention_step(
        T(enc), T(proj), T(hs), T(cs), T(tok).int(), T(params["h2h_kernel"]),
        T(params["h2h_bias"]), T(params["score_kernel"]).reshape(-1),
        T(params["lstm_kernel_ih"]), T(params["lstm_kernel_hh"]), T(params["lstm_bias"]),
        beam=k,
    )
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_ref), atol=2e-5, rtol=0)
    np.testing.assert_allclose(c_got.numpy(), np.asarray(c_ref), atol=2e-5, rtol=0)


def _quad_cases(rng, n):
    """Random convex quads, identical, edge-touching and disjoint pairs."""
    def boxes(m):
        w, h = rng.uniform(5, 60, m), rng.uniform(3, 30, m)
        cx, cy = rng.uniform(0, 100, m), rng.uniform(0, 100, m)
        th = rng.uniform(-0.6, 0.6, m)
        local = np.stack([[-w, -h], [w, -h], [w, h], [-w, h]], 0).transpose(2, 0, 1) / 2
        rot = np.stack([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]).transpose(2, 0, 1)
        return (local @ rot.transpose(0, 2, 1) + np.stack([cx, cy], 1)[:, None]).astype(np.float32)

    q1, q2 = boxes(n), boxes(n)
    k = n // 4
    q2[:k] = q1[:k]  # identical
    q2[k : 2 * k] = q1[k : 2 * k] + (q1[k : 2 * k, 1] - q1[k : 2 * k, 0])[:, None]  # touching
    q2[2 * k : 3 * k] = q1[2 * k : 3 * k] + np.float32(500.0)  # disjoint
    return q1, q2


@pytest.mark.parametrize("seed", [0, 1])
def test_quad_iou_pairs_plain_matches_jax(seed):
    rng = np.random.default_rng(seed)
    q1, q2 = _quad_cases(rng, 400)
    ref = np.asarray(quad_iou_pairs(jnp.asarray(q1), jnp.asarray(q2)))
    got = k2.quad_iou_pairs(torch.from_numpy(q1), torch.from_numpy(q2)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got[:100], 1.0, atol=5e-3)  # identical pairs
    assert np.all(got[200:300] == 0.0)  # disjoint pairs
    assert (ref > 0).mean() > 0.3  # the random pairs do overlap


def test_quad_iou_matrix_plain_matches_jax():
    rng = np.random.default_rng(3)
    a, b = _quad_cases(rng, 48)
    ref = np.asarray(quad_iou_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = k2.quad_iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (48, 48)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("n_live", [None, 137, 0])
def test_quad_iou_gather_plain_matches_jax(n_live):
    """Gathered pairs (random indices, repeats, self-pairs) against JAX
    quad_iou_pairs on the gathered quads; pairs from n_live on give 0."""
    rng = np.random.default_rng(7)
    a, b = _quad_cases(rng, 60)
    quads = np.concatenate([a, b])  # quad i and i + 60 form a test pair
    p = 300
    ia = rng.integers(0, 120, p).astype(np.int32)
    ib = rng.integers(0, 120, p).astype(np.int32)
    ia[:60], ib[:60] = np.arange(60), np.arange(60, 120)
    ib[60:70] = ia[60:70]  # self-pairs
    ref = np.array(quad_iou_pairs(jnp.asarray(quads[ia]), jnp.asarray(quads[ib])))
    live = p if n_live is None else n_live
    ref[live:] = 0.0
    got = k2.quad_iou_gather(
        torch.from_numpy(quads), torch.from_numpy(ia), torch.from_numpy(ib),
        None if n_live is None else torch.tensor(n_live, dtype=torch.int32),
    ).numpy()
    assert got.shape == (p,)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    if live:
        np.testing.assert_allclose(got[60:70], 1.0, atol=5e-3)  # a quad with itself
    assert np.all(got[live:] == 0.0)


@pytest.mark.parametrize("k,rows", [(3, 10), (0, 8), (4, 12)])
def test_attention_step_refuses_bad_beam(k, rows):
    """R must be B·beam with beam ≥ 1, on the plain route as on the card."""
    enc = torch.zeros(2, 4, 8)
    h = torch.zeros(rows, 8)
    z = torch.zeros
    args = (enc, enc, h, h, z(rows, dtype=torch.int32), z(8, 8), z(8), z(8), z(10, 32),
            z(8, 32), z(32))
    with pytest.raises(ValueError, match="beam"):
        k1.attention_step(*args, beam=k)


def test_random_quads_degenerate_pairs_match_jax():
    """Arbitrary (often non-convex, self-crossing) quads exercise the clip's
    dropped emits and empty polygons; counts must follow the reference."""
    rng = np.random.default_rng(11)
    q1 = rng.uniform(0, 50, (500, 4, 2)).astype(np.float32)
    q2 = rng.uniform(0, 50, (500, 4, 2)).astype(np.float32)
    q2[:50, :2] = q2[:50, 2:]  # repeated vertices
    ref = np.asarray(quad_iou_pairs(jnp.asarray(q1), jnp.asarray(q2)))
    got = k2.quad_iou_pairs(torch.from_numpy(q1), torch.from_numpy(q2)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


def test_wrappers_do_not_fall_back_off_the_cpu():
    """A tensor that is not on the CPU never takes the plain route: here a
    meta tensor is refused by the kernel route's device check."""
    q = torch.zeros(4, 4, 2, device="meta")
    with pytest.raises(ValueError, match="not CUDA"):
        k2.quad_iou_pairs(q, q)
    with pytest.raises(ValueError, match="not CUDA"):
        k2.quad_iou_matrix(q, q)
    idx = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="not CUDA"):
        k2.quad_iou_gather(q, idx, idx)
    e = torch.zeros(2, 3, 8, device="meta")
    h = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="not CUDA"):
        k1.attention_step(e, e, h, h, torch.zeros(2, dtype=torch.int32), h, h, h, h, h, h)


def test_kernel_library_missing_raises(monkeypatch, tmp_path):
    """Without nvcc and without a built library the kernel route raises
    instead of computing anything."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library("quad_iou")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        k1._lib()


def test_build_paths_track_source_and_flags():
    for name in _build.SOURCES:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.name.startswith(f"lib{name}-")
    assert "-fmad=false" in _build._flags("quad_iou")
    assert "arch=compute_90a,code=sm_90a" in _build._flags("attention_step")
