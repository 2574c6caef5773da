"""The port's CUDA kernels against their plain torch versions, on the card.

Run on a machine with an NVIDIA card: ``python -m pytest tests/test_torch_cuda.py``
(the kernels build with nvcc at first use). Without a card every test skips.
This file imports neither JAX nor the JAX package.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

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


def test_attention_step_refuses_inputs_that_require_grad(cuda):
    """The launch records no graph: under grad mode a weight that requires
    grad raises before anything is launched; under no_grad it runs."""
    args = list(_step_args(cuda, 4, 2, 16, 64, 50))
    args[5] = args[5].requires_grad_()
    before = k1.launches
    with pytest.raises(RuntimeError, match="no backward"):
        k1.attention_step(*args, beam=2)
    assert k1.launches == before
    with torch.no_grad():
        k1.attention_step(*args, beam=2)
    assert k1.launches == before + 1


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


@pytest.mark.parametrize("crop_source", ["native", "device"])
def test_two_shards_on_one_card_equal_no_mesh(cuda, crop_source):
    """The micro checkpoints through ``process_batch`` with a mesh of two
    shards on the one card (``make_mesh(devices=["cuda:0"] * 2)``, 2 pages
    a shard) equal the run without a mesh at 2 pages a chunk (the shapes
    each shard sees), TF32 off: equal texts, boxes within 1e-2 px; phase B
    ran one beam decode per shard and chunk."""
    from manuscript_tpu_torch import Pipeline
    from manuscript_tpu_torch.parallel import make_mesh
    from manuscript_tpu_torch.utils.quality import load_quality_models
    from manuscript_tpu_torch.utils.synthetic import eval_pages

    torch.backends.cudnn.allow_tf32 = False
    pages = [p for p, _ in eval_pages(5, seed=9100)]
    east, trba = load_quality_models("cuda")
    kw = dict(max_words=32, crop_source=crop_source)
    mesh = make_mesh(devices=["cuda:0"] * 2)
    pipe = Pipeline(east, trba, batch_pages=4, mesh=mesh, **kw)
    plain = Pipeline(east, trba, batch_pages=2, **kw)
    want = plain.process_batch(pages)
    before = k1.launches
    got = pipe.process_batch(pages)  # chunks of 4 and 1 (+1 repeated) pages
    assert k1.launches - before == 2 * 2 * trba.max_length
    for g, w in zip(got, want):
        gw, ww = ([x for b in p.blocks for x in b.words] for p in (g, w))
        assert [x.text for x in gw] == [x.text for x in ww] and len(gw) > 20
        for a, b in zip(gw, ww):
            np.testing.assert_allclose(a.polygon, b.polygon, atol=1e-2, rtol=0)


def test_tps_beam_on_the_card_equals_the_cpu(cuda):
    """``TRBAModel(use_tps=True)`` with the micro checkpoint's weights and a
    warping TPS from a seed: the beam tokens on the card (K1 in every step)
    equal the CPU's, the logits within 1e-3, TF32 off."""
    from manuscript_tpu_torch.models.trba import TRBAModel
    from manuscript_tpu_torch.recognizers import TRBA
    from manuscript_tpu_torch.utils.quality import QUALITY_DIR
    from manuscript_tpu_torch.utils.weights import init_random_

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = TRBA(QUALITY_DIR / "trba_micro.msgpack", device="cpu")
    model = TRBAModel(len(rec.itos), rec.hidden_size, rec.sos_id, rec.eos_id, rec.blank_id,
                      rec.cnn_stage_plan, use_tps=True)
    init_random_(model, 0)
    model.load_state_dict(rec.model.state_dict(), strict=False)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        dense = model.tps.localization.Dense_1
        dense.weight.copy_(torch.randn(dense.weight.shape, generator=gen) * 0.02)
    model.eval()
    x = torch.rand((16, rec.img_h, rec.img_w, 3), generator=gen) * 2 - 1
    with torch.no_grad():
        ref_logits, ref = model.beam(x, max_len=rec.max_length, beam_size=4)
        gpu = model.to(cuda)
        before = k1.launches
        logits, got = gpu.beam(x.to(cuda), max_len=rec.max_length, beam_size=4)
        torch.cuda.synchronize()
    assert k1.launches - before == rec.max_length
    assert torch.equal(got.cpu(), ref)
    torch.testing.assert_close(logits.cpu(), ref_logits, atol=1e-3, rtol=0)


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


def _candidate_field(rng, n, words=40, pad=0, size=800.0):
    """Jittered copies of word boxes with scores in [0.5, 1), shuffled, and
    ``pad`` padding rows (score −1)."""
    c = rng.uniform(0, size, (words, 2))
    wh = np.stack([rng.uniform(40, 160, words), rng.uniform(15, 40, words)], 1)
    base = np.concatenate([c - wh / 2, c + [1, -1] * wh / 2, c + wh / 2, c + [-1, 1] * wh / 2], 1)
    rows = base[rng.integers(0, words, n)] + rng.normal(0, 2.0, (n, 8))
    rows = np.concatenate([rows, rng.uniform(0.5, 1, (n, 1))], 1)
    rows = np.concatenate([rows, np.full((pad, 9), -1.0)])
    return rows[rng.permutation(len(rows))].astype(np.float32)


@pytest.mark.parametrize("pages,n,pad,max_out", [(1, 2048, 0, 1024), (3, 500, 300, 64), (2, 400, 0, 4)])
def test_lanms_merge_scan_kernel_matches_plain(cuda, pages, n, pad, max_out):
    """K3 against its plain twin on x0-sorted fields: equal counts (also
    past max_out), quads within 1e-3 px, equal scores; one launch."""
    from manuscript_tpu_torch.ops import lanms_torch as k3

    rng = np.random.default_rng(n)
    cands = torch.from_numpy(np.stack([_candidate_field(rng, n, pad=pad) for _ in range(pages)]))
    key = torch.where(cands[..., 8] >= 0, cands[..., 0], torch.full_like(cands[..., 0], float("inf")))
    rows = cands[torch.arange(pages)[:, None], torch.sort(key, dim=1, stable=True).indices].contiguous()
    before = k3.launches
    pk, sk, mk = k3.lanms_merge_scan(rows.to(cuda), 0.2, max_out)
    assert k3.launches == before + 1
    pp, sp, mp = k3.lanms_merge_scan_plain(rows, 0.2, max_out)
    assert torch.equal(mk.cpu(), mp)
    torch.testing.assert_close(pk.cpu(), pp, atol=1e-3, rtol=0)
    torch.testing.assert_close(sk.cpu(), sp, atol=0, rtol=0)
    got, n_got = k3.locality_aware_nms(cands.to(cuda), 0.2, max_out)
    want, n_want = k3.locality_aware_nms(cands, 0.2, max_out)
    assert torch.equal(n_got.cpu(), n_want)
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=0)


def test_lanms_merge_scan_refuses_what_it_does_not_take(cuda):
    from manuscript_tpu_torch.ops import lanms_torch as k3

    rows = torch.zeros(1, 8, 9, device=cuda)
    with pytest.raises(TypeError):
        k3.lanms_merge_scan(rows.double(), 0.2, 4)
    with pytest.raises(ValueError):
        k3.lanms_merge_scan(rows[:, :, :8].contiguous(), 0.2, 4)
    with pytest.raises(ValueError):
        k3.lanms_merge_scan(rows, 0.2, 0)


def test_host_lanms_library_builds_and_loads(cuda):
    """The C++ LANMS builds with the host compiler of the card's machine and
    gives the numpy twin's rows."""
    from manuscript_tpu_torch.ops import lanms

    rows = _candidate_field(np.random.default_rng(3), 400)
    np.testing.assert_array_equal(lanms.locality_aware_nms(rows, 0.2),
                                  lanms.locality_aware_nms_numpy(rows, 0.2))


# 90 % of the PERF_GATE line of the bench's first run on the card (NVIDIA
# H100 80GB HBM3, 700.00 W): 36.695 pages/s and an MFU of 0.148851 (PERF.md)
DEVICE_ONLY_FLOOR = 33.0
PROGRAM_MFU_FLOOR = 0.134


def test_perf_gate_floors(cuda):
    """``python -m manuscript_tpu_torch.bench --perf-gate`` at full size: the
    device-only pages/s of the device-crop page program (inputs held on the
    card, the host's eager launches included) and its MFU stay above floors,
    as tests/test_perf_gate.py holds the JAX package's."""
    env = {k: v for k, v in os.environ.items() if k != "MANUSCRIPT_TPU_BENCH_SMOKE"}
    run = subprocess.run([sys.executable, "-m", "manuscript_tpu_torch.bench", "--perf-gate"],
                         cwd=Path(__file__).resolve().parent.parent, env=env,
                         capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    line = next(ln for ln in run.stdout.splitlines() if ln.startswith("PERF_GATE "))
    gate = json.loads(line[len("PERF_GATE "):])
    assert gate["backend"] == "cuda" and gate["device"].startswith(torch.cuda.get_device_name(0))
    assert gate["device_only_pages_per_sec"] >= DEVICE_ONLY_FLOOR, gate
    assert PROGRAM_MFU_FLOOR <= gate["program_mfu"] <= 1.05, gate
