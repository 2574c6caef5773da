"""The port's CUDA kernels against their plain torch versions, on the card.

Run on a machine with an NVIDIA card: ``python -m pytest tests/test_torch_cuda.py``
(the kernels build with nvcc at first use). Without a card every test skips.
This file imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from manuscript_tpu_torch.ops import attention_step as k1
from manuscript_tpu_torch.ops import quad_iou as k2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _step_args(dev, b, k, t, h, v, seed=0):
    """Inputs of one decode step: B words of memory, B·k beam rows."""
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).to(dev)
    r = b * k
    return (rn(b, t, h), rn(b, t, h), rn(r, h, sc=0.5), rn(r, h, sc=0.5),
            torch.randint(0, v, (r,), generator=g, dtype=torch.int32).to(dev),
            rn(h, h, sc=h**-0.5), rn(h, sc=0.1), rn(h, sc=h**-0.5),
            rn(h + v, 4 * h, sc=h**-0.5), rn(h, 4 * h, sc=h**-0.5), rn(4 * h, sc=0.1))


@pytest.mark.parametrize("b,k,t,h,v", [
    (32, 8, 32, 256, 194), (128, 8, 32, 256, 194), (7, 1, 32, 256, 194), (5, 3, 16, 64, 50),
])
def test_attention_step_kernel_matches_plain(cuda, b, k, t, h, v):
    args = _step_args(cuda, b, k, t, h, v, seed=b)
    before, raw = k1.launches, k1.kernel_launches
    hk, ck = k1.attention_step(*args, beam=k)
    hp, cp = k1.attention_step_plain(*args, beam=k)
    assert k1.launches == before + 1 and k1.kernel_launches == raw + 3
    torch.testing.assert_close(hk, hp, atol=1e-4, rtol=0)
    torch.testing.assert_close(ck, cp, atol=1e-4, rtol=0)


def test_quad_iou_gather_matches_plain(cuda):
    rng = np.random.default_rng(1)
    quads = torch.from_numpy(rng.uniform(0, 50, (400, 4, 2)).astype(np.float32)).to(cuda)
    ia = torch.from_numpy(rng.integers(0, 400, 5000).astype(np.int32)).to(cuda)
    ib = torch.from_numpy(rng.integers(0, 400, 5000).astype(np.int32)).to(cuda)
    for n_live in (None, 1234, 0):
        live = None if n_live is None else torch.tensor(n_live, dtype=torch.int32, device=cuda)
        before = k2.launches
        got = k2.quad_iou_gather(quads, ia, ib, live)
        assert k2.launches == before + 1
        want = k2.quad_iou_gather_plain(quads, ia, ib, live)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
        if n_live is not None:
            assert torch.all(got[n_live:] == 0)


def test_quad_iou_gather_per_page_live_counts(cuda):
    """B = 4 pages of 16·64 slots, one page empty and one full: one launch."""
    rng = np.random.default_rng(2)
    quads = torch.from_numpy(rng.uniform(0, 50, (4 * 64, 4, 2)).astype(np.float32)).to(cuda)
    base = torch.arange(4, dtype=torch.int32, device=cuda).repeat_interleave(1024) * 64
    ia = base + torch.from_numpy(rng.integers(0, 64, 4096).astype(np.int32)).to(cuda)
    ib = base + torch.from_numpy(rng.integers(0, 64, 4096).astype(np.int32)).to(cuda)
    live = torch.tensor([100, 0, 1024, 513], dtype=torch.int32, device=cuda)
    before = k2.launches
    got = k2.quad_iou_gather(quads, ia, ib, live)
    assert k2.launches == before + 1
    want = k2.quad_iou_gather_plain(quads, ia, ib, live)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    for b, n in enumerate(live.tolist()):
        assert torch.all(got.reshape(4, 1024)[b, n:] == 0)


def test_process_batch_on_the_card(cuda):
    """The micro checkpoints through ``process_batch`` (2 pages a chunk) on
    the card equal a loop of ``predict``, and phase B ran one beam decode
    (max_length K1 steps) per chunk."""
    from manuscript_tpu_torch import Pipeline
    from manuscript_tpu_torch.utils.quality import load_quality_models
    from manuscript_tpu_torch.utils.synthetic import eval_pages

    torch.backends.cudnn.allow_tf32 = False
    pages = [p for p, _ in eval_pages(3, seed=9100)]
    pipe = Pipeline(*load_quality_models("cuda"), max_words=32, batch_pages=2)
    before = k1.launches
    batch = pipe.process_batch(pages)
    assert k1.launches - before == 2 * pipe.recognizer.max_length
    for got, page in zip(batch, pages):
        ref = [w for b in pipe.predict(page).blocks for w in b.words]
        words = [w for b in got.blocks for w in b.words]
        assert [w.text for w in words] == [w.text for w in ref] and len(words) > 20
        for a, b in zip(words, ref):
            np.testing.assert_allclose(a.polygon, b.polygon, atol=1e-2, rtol=0)


def test_quad_iou_kernels_match_plain(cuda):
    rng = np.random.default_rng(0)
    q1 = torch.from_numpy(rng.uniform(0, 50, (3000, 4, 2)).astype(np.float32)).to(cuda)
    q2 = q1 + torch.from_numpy(rng.normal(0, 3, (3000, 4, 2)).astype(np.float32)).to(cuda)
    torch.testing.assert_close(k2.quad_iou_pairs(q1, q2), k2.quad_iou_pairs_plain(q1, q2), atol=2e-5, rtol=0)
    a, b = q1[:200].contiguous(), q2[:300].contiguous()
    torch.testing.assert_close(k2.quad_iou_matrix(a, b), k2.quad_iou_matrix_plain(a, b), atol=2e-5, rtol=0)


def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(8, 4, 2, device=cuda)
    with pytest.raises(TypeError):
        k2.quad_iou_pairs(q.double(), q.double())
    with pytest.raises(ValueError):
        k2.quad_iou_pairs(q, q[:4])
    with pytest.raises(ValueError):
        k2.quad_iou_pairs(q.transpose(1, 2).contiguous().transpose(1, 2), q)
    idx = torch.zeros(5, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        k2.quad_iou_gather(q, idx.long(), idx)
    with pytest.raises(ValueError):
        k2.quad_iou_gather(q, idx, idx, torch.tensor(3, dtype=torch.int32))  # n_live on the CPU
    with pytest.raises(TypeError):
        k2.quad_iou_gather(q, idx, idx, torch.tensor(3, device=cuda))  # int64 n_live
    with pytest.raises(ValueError, match="pages"):  # 5 pairs in 2 pages
        k2.quad_iou_gather(q, idx, idx, torch.zeros(2, dtype=torch.int32, device=cuda))
    args = _step_args(cuda, 4, 2, 16, 64, 50)
    with pytest.raises(ValueError, match="beam"):
        k1.attention_step(*args, beam=3)  # 8 rows, not a multiple of 3
    with pytest.raises(ValueError, match="beam"):
        k1.attention_step(*args, beam=0)
    with pytest.raises(TypeError):
        k1.attention_step(*args[:4], args[4].long(), *args[5:], beam=2)
