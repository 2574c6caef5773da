"""The port's CUDA kernels against their plain torch versions, on the card.

Run on a machine with an NVIDIA card: ``python -m pytest tests/test_torch_cuda.py``
(the kernels build with nvcc at first use). Without a card every test skips.
This file imports neither JAX nor the JAX package.
"""

import json
import os
import subprocess
import sys
import time
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
    with pytest.raises(ValueError):
        k3.lanms_merge_scan_cuda(rows, 0.2, 4, _chunk=0)
    with pytest.raises(ValueError):
        k3.lanms_merge_scan_cuda(rows, 0.2, 4, _rewalks=-1)


def _x0_sorted(cands):
    """(B, K, 9) candidates in the merge walk's order: by x0, stable,
    padding last (as ``lanms_torch.locality_aware_nms`` sorts them)."""
    key = torch.where(cands[..., 8] >= 0, cands[..., 0], torch.full_like(cands[..., 0], float("inf")))
    order = torch.sort(key, dim=1, stable=True).indices
    return cands[torch.arange(cands.shape[0], device=cands.device)[:, None], order].contiguous()


def _k3_at_every_chunk(rows, thr, max_out):
    """K3 at chunk lengths K (one thread walks the page), 256, 64, 16, 1
    and the default, the default also with re-walk limits 0 and 1000: all
    bit-equal; → the K run's outputs, and its plain twin's on the CPU held
    to them (equal counts and scores, quads within 1e-3 px)."""
    from manuscript_tpu_torch.ops import lanms_torch as k3

    k = rows.shape[1]
    want = k3.lanms_merge_scan_cuda(rows, thr, max_out, _chunk=k)
    for chunk, rewalks in ((256, None), (64, None), (16, None), (1, None), (None, None),
                           (None, 0), (None, 1000)):
        got = k3.lanms_merge_scan_cuda(rows, thr, max_out, _chunk=chunk, _rewalks=rewalks)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (chunk, rewalks, g, w)
    pp, sp, mp = k3.lanms_merge_scan_plain(rows.cpu(), thr, max_out)
    assert torch.equal(want[2].cpu(), mp)
    torch.testing.assert_close(want[0].cpu(), pp, atol=1e-3, rtol=0)
    torch.testing.assert_close(want[1].cpu(), sp, atol=0, rtol=0)
    return want


@pytest.mark.parametrize("pages,n,pad,max_out", [(1, 2048, 0, 1024), (3, 500, 300, 64), (2, 400, 0, 4),
                                                 (1, 300, 0, 1)])
def test_lanms_merge_scan_chunks_are_bit_equal(cuda, pages, n, pad, max_out):
    """The chunked walks give the one-thread walk's outputs bit for bit,
    past max_out too (1 and 4 slots: the last slot holds the last quad)."""
    rng = np.random.default_rng(n + 1)
    cands = torch.from_numpy(np.stack([_candidate_field(rng, n, pad=pad) for _ in range(pages)]))
    _, _, count = _k3_at_every_chunk(_x0_sorted(cands).to(cuda), 0.2, max_out)
    assert max_out > 4 or bool((count > max_out).all())


def test_lanms_merge_scan_one_chain_page(cuda):
    """A page that never breaks (jittered copies of one quad): no chunk
    rejoins, every round settles one more chunk, and the result is the one
    merged quad of the sequential walk."""
    from manuscript_tpu_torch.ops import lanms_torch as k3

    rng = np.random.default_rng(5)
    n = 2048
    base = np.array([100, 50, 200, 50, 200, 80, 100, 80], np.float64)
    rows = np.concatenate([base + rng.normal(0, 2.0, (n, 8)), rng.uniform(0.5, 1, (n, 1))], 1)
    rows = _x0_sorted(torch.from_numpy(rows.astype(np.float32))[None]).to(cuda)
    _, _, count = _k3_at_every_chunk(rows, 0.2, 16)
    assert int(count[0]) == 1
    for limit in (0, 1, k3._K3_REWALKS):
        stats = {}
        k3.lanms_merge_scan_cuda(rows, 0.2, 16, _chunk=64, _rewalks=limit, _stats=stats)
        rounds, rewalks, walked, most, chunk = stats["fixup"][0].tolist()
        assert rounds == n // 64 - 1 and most == chunk == 64 and walked == 64 * rewalks
        # chunk c walks min(limit, c - 1) times from a predecessor that still
        # changes, then once as the front
        assert rewalks == sum(min(limit, c - 1) + 1 for c in range(1, n // 64))
        assert int((stats["code"][0] != 0).sum()) == 1


def test_lanms_merge_scan_pages_of_other_live_counts(cuda):
    """Pages with 2000, 700, 1 and 0 live rows of 2048 in one launch."""
    rng = np.random.default_rng(6)
    k = 2048
    pages = [np.concatenate([_candidate_field(rng, live, words=max(1, live // 16)),
                             np.full((k - live, 9), -1.0, np.float32)])
             for live in (2000, 700, 1, 0)]
    cands = torch.from_numpy(np.stack(pages))
    _, _, count = _k3_at_every_chunk(_x0_sorted(cands).to(cuda), 0.2, 512)
    assert int(count[2]) == 1 and int(count[3]) == 0


def test_lanms_merge_scan_on_the_micro_detector_candidates(cuda):
    """The candidate rows that the committed micro EAST gives on held-out
    pages (3 pages of 2048 slots, ~900–1000 live each), in one launch."""
    from manuscript_tpu_torch.ops.image import detector_preprocess_host
    from manuscript_tpu_torch.utils.quality import load_quality_models
    from manuscript_tpu_torch.utils.synthetic import eval_pages

    torch.backends.cudnn.allow_tf32 = False
    east, _ = load_quality_models("cuda")
    x = torch.stack([torch.from_numpy(np.ascontiguousarray(detector_preprocess_host(p, east.target_size)))
                     for p, _ in eval_pages(3, seed=9000)]).to(cuda)
    with torch.inference_mode():
        cands = east.candidates(*east.maps(x))
    assert bool(((cands[..., 8] >= 0).sum(1) > 100).all())
    _, _, count = _k3_at_every_chunk(_x0_sorted(cands), east.iou_threshold, east.max_boxes)
    assert bool((count > 10).all())


def test_host_lanms_library_builds_and_loads(cuda):
    """The C++ LANMS builds with the host compiler of the card's machine and
    gives the numpy twin's rows."""
    from manuscript_tpu_torch.ops import lanms

    rows = _candidate_field(np.random.default_rng(3), 400)
    np.testing.assert_array_equal(lanms.locality_aware_nms(rows, 0.2),
                                  lanms.locality_aware_nms_numpy(rows, 0.2))


def test_device_split_counts_the_backward_in_the_asam_passes(cuda, tmp_path):
    """On the card autograd launches a backward pass from a worker thread
    of its own; ``device_split`` counts its kernels in the regions around
    it all the same: ``optim.backward`` holds them, the two SAM passes hold
    their forwards, backwards, perturbation and restore, and the step holds
    nearly every launch of the trace."""
    from manuscript_tpu_torch.models.east import EASTModel
    from manuscript_tpu_torch.train import east_train, optim
    from manuscript_tpu_torch.utils import profiling

    torch.manual_seed(0)
    model = EASTModel("resnet50-micro").to(cuda)
    mask = east_train.freeze_mask(model, True)
    trainable = {k: p for k, p in model.named_parameters() if mask[k]}
    tx, _ = optim.build_east_optimizer(1e-3, 2, use_sam=True)
    state = east_train.EASTTrainState(model, tx.init(trainable), None)
    image = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8, device=cuda)
    score = (torch.rand(2, 16, 16, device=cuda) > 0.7).float()
    geo = torch.randn(2, 16, 16, 8, device=cuda) * 4
    east_train.train_step(state, tx, trainable, image, score, geo)  # warm
    with profiling.trace(tmp_path) as prof:
        east_train.train_step(state, tx, trainable, image, score, geo)
    split = profiling.device_split(prof)
    r = {k: v["launches"] for k, v in split["regions"].items()}
    assert split["regions"]["optim.backward"]["count"] == 2
    assert r["optim.backward"] >= r["east.forward"] / 2 > 0, r
    assert (r["sam.first_pass"] + r["sam.second_pass"]
            >= r["east.forward"] + r["optim.backward"] + r["sam.perturb"] + r["sam.restore"]), r
    assert r["east.step"] >= 0.95 * split["launches"], (r, split["launches"])


# 90 % of the PERF_GATE line of the bench's first run on the card, 36.695
# pages/s and an MFU of 0.148851 (a later run read 38.066 / 0.154413), at 128
# word slots and ~4.0e12 FLOPs a page (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md §6): the floors hold on the workload that the bench pins
DEVICE_ONLY_FLOOR = 33.0
PROGRAM_MFU_FLOOR = 0.134


def test_perf_gate_floors(cuda):
    """``python -m manuscript_tpu_torch.bench --perf-gate`` at full size: the
    device-only pages/s of the device-crop page program (inputs held on the
    card, the host's eager launches included) and its MFU stay above floors,
    as tests/test_perf_gate.py holds the JAX package's, on the bench's pinned
    workload (``BENCH_CAPACITY`` word slots, ``BENCH_WORDS`` words a page)."""
    from manuscript_tpu_torch.bench import BENCH_CAPACITY, BENCH_WORDS

    env = {k: v for k, v in os.environ.items() if k != "MANUSCRIPT_TPU_BENCH_SMOKE"}
    run = subprocess.run([sys.executable, "-m", "manuscript_tpu_torch.bench", "--perf-gate"],
                         cwd=Path(__file__).resolve().parent.parent, env=env,
                         capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    line = next(ln for ln in run.stdout.splitlines() if ln.startswith("PERF_GATE "))
    gate = json.loads(line[len("PERF_GATE "):])
    assert gate["backend"] == "cuda" and gate["device"].startswith(torch.cuda.get_device_name(0))
    assert gate["word_capacity"] == BENCH_CAPACITY == 128, gate
    assert BENCH_WORDS[0] <= gate["words_per_page"] <= BENCH_WORDS[1], gate
    assert gate["device_only_pages_per_sec"] >= DEVICE_ONLY_FLOOR, gate
    assert PROGRAM_MFU_FLOOR <= gate["program_mfu"] <= 1.05, gate


# ---- the EAST step's multi-tensor kernels (ops/multi_tensor.py) ----

MT_DTYPES = [torch.float32, torch.float64, torch.bfloat16]
# the kernels' norm against float64's: float32 and float64 sum in double; a
# bfloat16 norm is rounded to bfloat16
MT_NORM_REL = {torch.float32: 2e-6, torch.float64: 2e-6, torch.bfloat16: 4e-3}


def _mt_leaves(dev, case, seed=0, scale=1.0, dtype=torch.float32):
    """(params, grads) of a leaf set: odd sizes; views at storage offsets that
    are not aligned to 4 elements; (O, C, K, K) leaves whose gradients are
    channels_last, as autograd returns a convolution's here; or whose
    parameters are channels_last too ("strided")."""
    g = torch.Generator().manual_seed(seed)
    rn = lambda n, sc=1.0: (torch.randn(n, generator=g) * sc).to(dev, dtype)  # noqa: E731
    if case == "sizes":
        sizes = [1, 3, 512, 4097, 2**20 + 5]
        return [rn(n) for n in sizes], [rn(n, scale) for n in sizes]
    if case == "views":
        sizes = [5, 4096, 33, 70001, 2]
        pbase, gbase = rn(sum(sizes) + 40), rn(sum(sizes) + 40, scale)
        params, grads, at = [], [], 0
        for i, n in enumerate(sizes):
            at += 1 + i % 3
            params.append(pbase[at:at + n])
            grads.append(gbase[at + 1:at + 1 + n])
            at += n
        assert any(p.data_ptr() % (4 * p.element_size()) for p in params)
        return params, grads
    shapes = [(64, 32, 3, 3), (16, 3, 7, 7), (128, 64, 1, 1), (64,), (5, 7, 3, 3)]
    params = [rn(int(np.prod(s))).reshape(s) for s in shapes]
    grads = [rn(int(np.prod(s)), scale).reshape(s) for s in shapes]
    cl = lambda ts: [t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t  # noqa: E731
                     for t in ts]
    grads = cl(grads)
    assert sum(not t.is_contiguous() for t in grads) == 3
    return (cl(params) if case == "strided" else params), grads


def _mt_bits(ts):
    kind = {torch.float32: torch.int32, torch.float64: torch.int64, torch.bfloat16: torch.int16}
    return [t.contiguous().view(kind[t.dtype]) for t in ts]


def _mt_equal(got, want):
    for a, b in zip(_mt_bits(got), _mt_bits(want), strict=True):
        assert torch.equal(a, b)


def _norm64(ts):
    return float(torch.sqrt(sum((t.double() ** 2).sum() for t in ts)))


def _mt_check_perturb(params, grads, adaptive):
    """The kernels' perturbation against the twin given the kernels' norm
    (bit for bit), the norm against float64's, the restore exact; →
    (perturbed params, norm)."""
    from manuscript_tpu_torch.ops import multi_tensor as mt

    dev, dtype = params[0].device, params[0].dtype
    p_k, p_t = [p.clone() for p in params], [p.clone() for p in params]
    norm = torch.empty(1, device=dev, dtype=dtype)
    saved = mt.perturb_cuda(p_k, grads, 0.05, adaptive, norm_out=norm)
    mt.perturb_plain(p_t, grads, 0.05, adaptive, norm=norm[0])
    _mt_equal(p_k, p_t)
    want = _norm64([p.abs() * g for p, g in zip(params, grads)] if adaptive else grads)
    assert abs(float(norm) - want) <= MT_NORM_REL[dtype] * want, (float(norm), want)
    out = [p.clone() for p in p_k]
    mt.restore_cuda(p_k, saved)
    _mt_equal(p_k, params)
    return out, norm


def _mt_check_update(params, grads, loss_value, loss_dtype=None):
    """The kernels' guarded clip → SGD → apply against the twin given the
    kernels' norm (bit for bit), the norm against float64's; the traces in
    the parameters' layout; → (params, traces, norm)."""
    from manuscript_tpu_torch.ops import multi_tensor as mt
    from multi_tensor_twin import clip_sgd_apply_twin

    dev, dtype = params[0].device, params[0].dtype
    gen = torch.Generator().manual_seed(9)
    traces = [(torch.randn(p.shape, generator=gen) * 0.1).to(dev, dtype).contiguous(
        memory_format=torch.channels_last if not p.is_contiguous() else torch.contiguous_format)
        for p in params]
    loss = torch.tensor(loss_value, device=dev, dtype=loss_dtype or dtype)
    p_k, p_t = [p.clone() for p in params], [p.clone() for p in params]
    t_k, t_t = [t.clone() for t in traces], [t.clone() for t in traces]
    norm = torch.empty(1, device=dev, dtype=dtype)
    mt.clip_sgd_apply_cuda(loss, grads, t_k, p_k, 5.0, -0.125, 0.9, norm_out=norm)
    clip_sgd_apply_twin(loss, grads, t_t, p_t, 5.0, -0.125, 0.9, norm=norm[0])
    _mt_equal(p_k, p_t)
    _mt_equal(t_k, t_t)
    want = _norm64(grads) if np.isfinite(loss_value) else 0.0
    assert abs(float(norm) - want) <= MT_NORM_REL[dtype] * want, (float(norm), want)
    assert all(torch.isfinite(t).all() for t in p_k + t_k)
    return p_k, t_k, norm


@pytest.mark.parametrize("dtype", MT_DTYPES)
@pytest.mark.parametrize("case", ["sizes", "views", "channels_last", "strided"])
@pytest.mark.parametrize("adaptive", [True, False])
def test_multi_tensor_perturb_matches_the_twin(cuda, case, adaptive, dtype):
    from manuscript_tpu_torch.ops import multi_tensor as mt

    params, grads = _mt_leaves(cuda, case, seed=len(case), dtype=dtype)
    before = mt.kernel_launches
    _mt_check_perturb(params, grads, adaptive)
    assert mt.kernel_launches == before + 3  # sum of squares, perturbation, restore


@pytest.mark.parametrize("dtype", MT_DTYPES)
@pytest.mark.parametrize("case", ["sizes", "views", "channels_last", "strided"])
@pytest.mark.parametrize("loss_value,scale", [(2.0, 1e-4), (2.0, 1.0), (float("nan"), 1.0),
                                              (float("inf"), 1e-4)])
def test_multi_tensor_update_matches_the_twin(cuda, case, loss_value, scale, dtype):
    """Under the clip and clipped (scale 1: the norm passes 5), and with a
    non-finite loss (every gradient zeroed, the trace decays)."""
    params, grads = _mt_leaves(cuda, case, seed=7, scale=scale, dtype=dtype)
    _, _, norm = _mt_check_update(params, grads, loss_value)
    if np.isfinite(loss_value):
        assert (float(norm) < 5.0) == (scale < 1)


def _mt_east_r101(dev):
    """The parameters of a seeded EASTModel("resnet101") and their gradients
    from one ASAM-style backward of a small batch (their layouts as autograd
    returns them)."""
    from manuscript_tpu_torch.models.east import EASTModel
    from manuscript_tpu_torch.train import east_train
    from manuscript_tpu_torch.utils.weights import init_random_

    model = init_random_(EASTModel("resnet101"), 0).to(dev)
    model.train()
    g = torch.Generator(device=dev).manual_seed(0)
    image = torch.randint(0, 256, (1, 128, 128, 3), dtype=torch.uint8, device=dev, generator=g)
    score = (torch.rand(1, 32, 32, device=dev, generator=g) > 0.8).float()
    geo = torch.randn(1, 32, 32, 8, device=dev, generator=g) * 4
    params = list(model.parameters())
    loss = east_train.east_train_loss(model, image, score, geo, True, 0.5, True, 2.0)
    grads = list(torch.autograd.grad(loss, params, allow_unused=True))
    grads = [torch.zeros_like(p) if gr is None else gr for p, gr in zip(params, grads)]
    return [p.detach() for p in params], grads


def test_multi_tensor_on_the_east_r101_leaf_set_repeats_bit_for_bit(cuda):
    """The detector's 348 leaves (47.2 M elements, the KxK convolutions'
    gradients channels_last) against the twin, and two runs equal bit for
    bit."""
    from manuscript_tpu_torch.ops import multi_tensor as mt

    params, grads = _mt_east_r101(cuda)
    assert len(params) == 348 and sum(p.numel() for p in params) == 47_185_801
    assert any(not gr.is_contiguous() for gr in grads)
    assert mt.on_card(params, grads)
    runs = [_mt_check_perturb(params, grads, True) for _ in range(2)]
    _mt_equal(runs[0][0] + [runs[0][1]], runs[1][0] + [runs[1][1]])
    norm = _norm64(grads)
    for total in (1.0, 100.0):  # under the clip (5) and over it
        g = [gr * (total / norm) for gr in grads]
        runs = [_mt_check_update(params, g, 1.5) for _ in range(2)]
        _mt_equal(runs[0][0] + runs[0][1] + [runs[0][2]], runs[1][0] + runs[1][1] + [runs[1][2]])


def test_multi_tensor_step_does_not_wait_for_the_card(cuda):
    """With ≥ 50 ms of work queued on the stream (``torch.cuda._sleep``) a
    fused perturbation, restore and update at the EAST-R101 leaf set return
    on the host long before that work ends: no launch synchronises."""
    from manuscript_tpu_torch.ops import multi_tensor as mt

    params, grads = _mt_east_r101(cuda)
    params = [p.clone() for p in params]
    traces = [torch.zeros_like(p) for p in params]
    loss = torch.tensor(1.0, device=cuda)

    def fused():
        mt.restore(params, mt.perturb(params, grads, 0.05, True))
        mt.clip_sgd_apply(loss, grads, traces, params, 5.0, -1e-3, 0.9)

    before = mt.kernel_launches
    fused()  # build, load and allocate
    assert mt.kernel_launches == before + 5
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    cycles = int(10_000_000 * 100 / start.elapsed_time(end))  # ~100 ms of sleep
    torch.cuda.synchronize()
    done = torch.cuda.Event()
    torch.cuda._sleep(cycles)
    done.record()
    t0 = time.perf_counter()
    fused()
    host_ms = (time.perf_counter() - t0) * 1e3
    pending = not done.query()
    torch.cuda.synchronize()
    print(f"fused perturb + restore + update at 348 leaves: {host_ms:.3f} host ms "
          f"behind ~100 ms of queued work")
    assert pending and host_ms < 25.0, host_ms


def test_a_traced_asam_step_opens_three_multi_tensor_spans(cuda, tmp_path):
    """float32 and float64 on the card alike: one ``optim.multi_tensor`` span
    in each of ``sam.perturb``, ``sam.restore`` and ``east.update``, and 5
    kernel launches a step."""
    from manuscript_tpu_torch.models.east import EASTModel
    from manuscript_tpu_torch.ops import multi_tensor as mt
    from manuscript_tpu_torch.train import east_train, optim
    from manuscript_tpu_torch.utils import profiling

    for dtype in (torch.float32, torch.float64):
        torch.manual_seed(0)
        model = EASTModel("resnet50-micro").to(cuda, dtype)
        mask = east_train.freeze_mask(model, True)
        trainable = {k: p for k, p in model.named_parameters() if mask[k]}
        tx, _ = optim.build_east_optimizer(1e-3, 2, use_sam=True)
        state = east_train.EASTTrainState(model, tx.init(trainable), None)
        image = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8, device=cuda)
        score = (torch.rand(2, 16, 16, device=cuda) > 0.7).float().to(dtype)
        geo = (torch.randn(2, 16, 16, 8, device=cuda) * 4).to(dtype)
        east_train.train_step(state, tx, trainable, image, score, geo)  # warm
        before = mt.kernel_launches
        with profiling.trace(tmp_path / str(dtype)) as prof:
            east_train.train_step(state, tx, trainable, image, score, geo)
        assert mt.kernel_launches == before + 5, dtype
        cpu = torch.autograd.DeviceType.CPU
        regions = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == cpu and e.is_user_annotation]
        fused = [r for r in regions if r[0] == "optim.multi_tensor"]
        assert len(fused) == 3, regions
        for outer in ("sam.perturb", "sam.restore", "east.update"):
            (o,) = [r for r in regions if r[0] == outer]
            assert len([r for r in fused if o[1] <= r[1] and r[2] <= o[2]]) == 1


def test_multi_tensor_update_on_the_card_is_in_place_and_refuses_what_it_cannot_take(cuda):
    """``tx.step`` on the card writes the trace and the parameters in place
    and keeps the state's layout; a float64 step takes a float32 NaN loss
    (every gradient zeroed); leaves on two devices, of two types, or a
    written tensor of another layout raise ``ValueError``."""
    from manuscript_tpu_torch.ops import multi_tensor as mt
    from manuscript_tpu_torch.train import optim

    tx, schedule = optim.build_east_optimizer(0.5, 2, use_sam=True, grad_clip=1e9, t_0=1)
    params = {"w": torch.zeros(4, device=cuda), "k": torch.zeros(2, 3, 2, 2, device=cuda)}
    state = tx.init(params)
    trace, w = state["1"]["0"]["trace"]["w"], params["w"]
    state["1"]["1"]["count"] = 5
    grads = {k: torch.ones_like(p) for k, p in params.items()}
    out = tx.step(torch.tensor(1.0, device=cuda), grads, state, params)
    assert out["1"]["0"]["trace"]["w"] is trace and torch.equal(trace, torch.ones(4, device=cuda))
    assert out["1"]["1"]["count"] == 6 and out["0"] == {}
    assert params["w"] is w and torch.equal(w, torch.full((4,), -schedule(5), device=cuda))

    p64 = [torch.ones(5, device=cuda, dtype=torch.float64)]
    t64 = [torch.ones_like(p64[0])]
    mt.clip_sgd_apply(torch.tensor(float("nan"), device=cuda), [torch.ones_like(p64[0])], t64,
                      p64, 5.0, -1.0, 0.5)
    assert torch.equal(t64[0], torch.full_like(t64[0], 0.5)) and torch.equal(p64[0], t64[0])

    p = [torch.zeros(4, 6, device=cuda)]
    with pytest.raises(ValueError, match="one type on one card"):
        mt.perturb(p, [torch.zeros(4, 6, device=cuda, dtype=torch.float64)], 0.05, True)
    with pytest.raises(ValueError, match="one type on one card"):
        mt.perturb(p, [torch.zeros(4, 6)], 0.05, True)
    odd = [torch.zeros(6, 4, device=cuda).t()]
    with pytest.raises(ValueError, match="neither row-major nor channels_last"):
        mt.perturb(odd, [torch.zeros(4, 6, device=cuda)], 0.05, True)


# ---- K7: train-mode BatchNorm with residual and ReLU (ops/batch_norm.py) ----

BN_DTYPES = [torch.float32, torch.float64, torch.bfloat16]
# largest gap against the twin over the larger of 1 and the twin's largest
# entry: float32 and bfloat16 sum in float32 in another order (and bfloat16
# rounds its outputs, one ulp 2^-8), float64 in float64
BN_TOL = {torch.float32: 1e-4, torch.float64: 1e-11, torch.bfloat16: 2e-2}
# (shape, layout): channels_last and row-major 4-D, 2-D; the micro and
# decoder plans' ragged channel counts (8, 32), a count off the 4-wide loads
# (3, 10), fewer rows than a block's tile, and layer4's width on 8 rows
BN_CASES = [((4, 32, 24, 20), "channels_last"), ((2, 8, 5, 3), "channels_last"),
            ((3, 3, 7, 5), "channels_last"), ((2, 2048, 2, 2), "channels_last"),
            ((4, 32, 24, 20), "row_major"), ((2, 8, 5, 3), "row_major"),
            ((3, 10, 6, 2), "row_major"), ((6, 16), "2d"), ((3, 10), "2d")]


def _bn_inputs(dev, shape, lay, dtype, residual, seed=0, offset=0.5):
    g = torch.Generator().manual_seed(seed)
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    fmt = torch.channels_last if lay == "channels_last" else torch.contiguous_format
    rn = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)  # noqa: E731
    x = (rn(*shape) * 2 + offset).to(dev, dtype).contiguous(memory_format=fmt)
    r = rn(*shape).to(dev, dtype).contiguous(memory_format=fmt) if residual else None
    c = shape[1]
    w = (torch.rand(c, generator=g, dtype=torch.float64) + 0.5).to(dev, acc)
    b = (rn(c) * 0.3).to(dev, acc)
    rm, rv = rn(c).to(dev, acc), (torch.rand(c, generator=g, dtype=torch.float64) + 0.5).to(dev, acc)
    up = rn(*shape).to(dev, dtype).contiguous(memory_format=fmt)
    return x, r, w, b, rm, rv, up


def _bn_gap(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) / max(1.0, float(b.double().abs().max()))


def _bn_bits(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(torch.uint8),
                                              b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("mode", ["plain", "relu", "residual_relu"])
@pytest.mark.parametrize("dtype", BN_DTYPES)
def test_batch_norm_kernel_matches_the_twin(cuda, dtype, mode):
    """Forward (output, mean and invstd, running statistics) and backward
    (dx, dr, dweight, dbias given the kernel's forward) against the twin on
    the card, in 4 launches a call, each output in x's layout."""
    from manuscript_tpu_torch.ops import batch_norm as bn

    residual, relu = mode == "residual_relu", mode != "plain"
    for i, (shape, lay) in enumerate(BN_CASES):
        x, r, w, b, rm, rv, up = _bn_inputs(cuda, shape, lay, dtype, residual, seed=i)
        rm_t, rv_t = rm.clone(), rv.clone()
        before = bn.launches
        y, st = bn.forward_cuda(x, r, w, b, rm, rv, True, 0.9, 1e-5, relu)
        grads = bn.backward_cuda(up, x, y if residual else None, st, w, b, relu, residual)
        assert bn.launches == before + 4, (shape, lay)
        y_t, st_t = bn.forward_plain(x, r, w, b, rm_t, rv_t, True, 0.9, 1e-5, relu)
        want = bn.backward_plain(up, x, y, st, w, relu, residual)
        assert y.stride() == x.stride() and grads[0].stride() == x.stride()
        gaps = [_bn_gap(y, y_t), _bn_gap(st, st_t), _bn_gap(rm, rm_t), _bn_gap(rv, rv_t)]
        gaps += [_bn_gap(a, e) for a, e in zip(grads, want) if e is not None]
        assert (grads[1] is None) == (not residual)
        assert max(gaps) <= BN_TOL[dtype], (shape, lay, gaps)


@pytest.mark.parametrize("dtype", BN_DTYPES)
def test_batch_norm_repeats_bit_for_bit_at_the_east_cells_shapes(cuda, dtype):
    """The EAST cell's stem (786,432 rows × 64) and a layer3 block's last
    BatchNorm (12,288 × 1024, residual and ReLU), channels_last: two runs
    equal bit for bit, and within the tolerance of the twin."""
    from manuscript_tpu_torch.ops import batch_norm as bn

    for shape, residual in (((3, 64, 512, 512), False), ((3, 1024, 64, 64), True)):
        x, r, w, b, rm, rv, up = _bn_inputs(cuda, shape, "channels_last", dtype, residual)
        runs = []
        for _ in range(2):
            y, st = bn.forward_cuda(x, r, w, b, rm, rv, False, 0.9, 1e-5, True)
            runs.append([y, st, *(t for t in bn.backward_cuda(up, x, y, st, w, b, True, residual)
                                  if t is not None)])
        assert all(_bn_bits(a, e) for a, e in zip(*runs)), shape
        y, st = runs[0][:2]
        y_t, st_t = bn.forward_plain(x, r, w, b, rm, rv, False, 0.9, 1e-5, True)
        want = [t for t in bn.backward_plain(up, x, y, st, w, True, residual) if t is not None]
        gaps = [_bn_gap(y, y_t), _bn_gap(st, st_t)] + [_bn_gap(a, e)
                                                       for a, e in zip(runs[0][2:], want)]
        assert max(gaps) <= BN_TOL[dtype], (shape, gaps)


@pytest.mark.parametrize("lay", ["channels_last", "row_major"])
def test_batch_norm_kernel_keeps_the_variance_of_a_channel_far_from_zero(cuda, lay):
    """Mean 1e4 times the spread in float32: Welford's running variance is
    within 1e-4 of float64's."""
    from manuscript_tpu_torch.ops import batch_norm as bn

    x, _, w, b, rm, rv, _ = _bn_inputs(cuda, (3, 64, 96, 80), lay, torch.float32, False,
                                       offset=0.0)
    x = (x * 0.25 + 1e4).contiguous(memory_format=torch.channels_last if lay == "channels_last"
                                    else torch.contiguous_format)
    bn.forward_cuda(x, None, w, b, rm, rv, True, 0.0, 1e-5, False)  # momentum 0: the batch's
    exact = x.double().var([0, 2, 3], unbiased=False)
    assert float(((rv.double() - exact).abs() / exact).max()) <= 1e-4


@pytest.mark.parametrize("needs", ["x", "residual", "weights"])
@pytest.mark.parametrize("lay", ["channels_last", "row_major"])
def test_batch_norm_gradients_when_only_some_inputs_need_them(cuda, lay, needs):
    """Residual + ReLU through the autograd Function in float64 where only
    x, only the residual or only weight and bias need a gradient: the
    kernels mask with y = BN(x) + r <= 0 whichever they are, and each
    wanted gradient equals the twin's on the CPU."""
    from manuscript_tpu_torch.ops import batch_norm as bn

    x, r, w, b, rm, rv, up = _bn_inputs(cuda, (4, 32, 24, 20), lay, torch.float64, True)
    flags = {"x": (True, False, False), "residual": (False, True, False),
             "weights": (False, False, True)}[needs]
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        ins = [x.to(dev).requires_grad_(flags[0]), r.to(dev).requires_grad_(flags[1]),
               w.to(dev).requires_grad_(flags[2]), b.to(dev).requires_grad_(flags[2])]
        y = bn.batch_norm(*ins, rm.to(dev), rv.to(dev), False, 0.9, 1e-5, True)
        grads[dev.type] = torch.autograd.grad(y, [t for t in ins if t.requires_grad], up.to(dev))
    gaps = [_bn_gap(a.cpu(), e) for a, e in zip(grads["cuda"], grads["cpu"])]
    assert max(gaps) <= BN_TOL[torch.float64], gaps


def test_batch_norm_on_two_streams_at_once_keeps_each_result(cuda):
    """The stem's and a layer3 block's BatchNorm forward and backward queued
    on two streams of one card at once, each behind a sleep so that they
    overlap: every output equals a run of each alone bit for bit, since each
    stream keeps its own ticket counters."""
    from manuscript_tpu_torch.ops import batch_norm as bn

    cases = [_bn_inputs(cuda, shape, "channels_last", torch.float32, res, seed=i)
             for i, (shape, res) in enumerate((((3, 64, 256, 256), False),
                                               ((3, 1024, 64, 64), True)))]

    def run(x, r, w, b, rm, rv, up):
        y, st = bn.forward_cuda(x, r, w, b, rm, rv, False, 0.9, 1e-5, True)
        return [y, st, *(t for t in bn.backward_cuda(up, x, y, st, w, b, True, r is not None)
                         if t is not None)]

    alone = [run(*c) for c in cases]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    together = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for s, c in zip(streams, cases):
        with torch.cuda.stream(s):
            torch.cuda._sleep(20_000_000)
            together.append([run(*c) for _ in range(3)])
    torch.cuda.synchronize()
    assert bn._tickets_of(cuda, streams[0].cuda_stream) != bn._tickets_of(
        cuda, streams[1].cuda_stream)
    for want, runs in zip(alone, together):
        assert all(_bn_bits(a, e) for got in runs for a, e in zip(got, want))


def test_batch_norm_kernels_refuse_what_they_do_not_take(cuda):
    from manuscript_tpu_torch.ops import batch_norm as bn

    v = torch.ones(6, device=cuda)
    x = torch.randn(2, 6, 4, 4, device=cuda)
    before = bn.launches
    with pytest.raises(ValueError, match="neither row-major"):
        bn.batch_norm(torch.randn(6, 4, device=cuda).t(), None, v, v, v, v, True, 0.9, 1e-5,
                      False)
    with pytest.raises(ValueError, match="kernels take"):
        bn.batch_norm(x.half(), None, v, v, v, v, True, 0.9, 1e-5, False)
    with pytest.raises(ValueError, match="weight"):
        bn.batch_norm(x, None, v.double(), v, v, v, True, 0.9, 1e-5, False)
    with pytest.raises(ValueError, match="residual"):
        bn.batch_norm(x, x.contiguous(memory_format=torch.channels_last), v, v, v, v, True, 0.9,
                      1e-5, True)
    assert bn.launches == before


def test_an_east_train_step_runs_every_batch_norm_through_k7(cuda, tmp_path):
    """A micro EAST ASAM step: each train-mode BatchNorm through the kernels
    in each of the two passes (4 launches a call, none through the twin),
    each forward in a ``bn.forward`` span and each backward in a
    ``bn.backward`` span."""
    from manuscript_tpu_torch.models.east import EASTModel
    from manuscript_tpu_torch.models.layers import BatchNorm
    from manuscript_tpu_torch.ops import batch_norm as bn
    from manuscript_tpu_torch.train import east_train, optim
    from manuscript_tpu_torch.utils import profiling

    torch.manual_seed(0)
    model = EASTModel("resnet50-micro").to(cuda)
    layers = sum(isinstance(m, BatchNorm) for m in model.modules())
    mask = east_train.freeze_mask(model, True)
    trainable = {k: p for k, p in model.named_parameters() if mask[k]}
    tx, _ = optim.build_east_optimizer(1e-3, 2, use_sam=True)
    state = east_train.EASTTrainState(model, tx.init(trainable), None)
    image = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8, device=cuda)
    score = (torch.rand(2, 16, 16, device=cuda) > 0.7).float()
    geo = torch.randn(2, 16, 16, 8, device=cuda) * 4
    east_train.train_step(state, tx, trainable, image, score, geo)  # warm
    calls, launches = dict(bn.calls), bn.launches
    with profiling.trace(tmp_path) as prof:
        east_train.train_step(state, tx, trainable, image, score, geo)
    assert bn.calls["kernel"] - calls.get("kernel", 0) == 2 * layers
    assert bn.calls["twin"] == calls.get("twin", 0)
    assert bn.launches - launches == 8 * layers
    cpu = torch.autograd.DeviceType.CPU
    names = [e.name for e in prof.events() if e.device_type == cpu and e.is_user_annotation]
    assert names.count("bn.forward") == names.count("bn.backward") == 2 * layers


# ---- K8: the beam's advance (ops/beam_select.py) ----

# (B, k, V): TrOCR's line (one and the cell's 128), TRBA's cell (512 × 8 ×
# 194) and a few of its lines; the first two take two launches, the rest one
BS_CASES = [(1, 4, 50265), (128, 4, 50265), (512, 8, 194), (3, 8, 194)]
BS_EOS = 2  # both configurations' EOS lies low in the vocabulary


def _bs_state(dev, b, k, v, seed, integer=False):
    """Logits (B·k, V), scores (B, k) and finished (B, k): about a third of
    the beams finished and line 0 wholly; ``integer`` logits (a few values
    each repeated many times in a row) and beam k//2 a copy of beam 0, row
    and score, so that exact ties are everywhere."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(b * k, v, generator=g) * 3
    scores = -torch.rand(b, k, generator=g) * 5
    if integer:
        logits = logits.round().reshape(b, k, v)
        logits[:, k // 2] = logits[:, 0]
        logits = logits.reshape(b * k, v)
        scores[:, k // 2] = scores[:, 0]
    finished = torch.rand(b, k, generator=g) < 0.3
    finished[0] = True
    return logits.to(dev), scores.to(dev), finished.to(dev)


def _bs_separated(logits, scores, finished, eos, temperature, lp, k):
    """(B,) whether each line's k + 1 best composed scores lie more than
    1e-4 apart, or exactly together: lines where a float32 rounding cannot
    swap the kept beams between two ways of computing them."""
    from manuscript_tpu_torch.ops import beam_select as bs

    x = bs.next_scores_plain(logits, scores, finished, eos, temperature, lp)
    top, _ = bs.topk_lowest_index(x, k + 1)
    gaps = top[:, :-1] - top[:, 1:]
    return ((gaps > 1e-4) | (gaps == 0)).all(1)


def _bs_launches(b, k, v):
    from manuscript_tpu_torch.ops import beam_select as bs

    return 1 + bs.plan(b, k, v, torch.cuda.get_device_properties(0).multi_processor_count).two


@pytest.mark.parametrize("temperature", [1.0, 1.7])
@pytest.mark.parametrize("alpha", [0.0, 0.9])
@pytest.mark.parametrize("b, k, v", BS_CASES)
def test_beam_select_kernel_matches_the_plain_version(cuda, b, k, v, alpha, temperature):
    """K8 against the plain version on the card: parents, tokens and
    finished flags equal on every line whose kept beams are separated,
    scores within 2e-6 relative, finished beams continuing only with EOS,
    two runs bit-equal, one or two launches a call."""
    from manuscript_tpu_torch.models.beam import length_scale
    from manuscript_tpu_torch.ops import beam_select as bs

    logits, scores, finished = _bs_state(cuda, b, k, v, seed=b + k)
    rows = torch.arange(b, device=cuda)[:, None]
    lp = length_scale(3, alpha) if alpha > 0 else None
    before = bs.launches
    got = bs.beam_select(logits, scores, finished, rows, BS_EOS, temperature, lp)
    again = bs.beam_select(logits, scores, finished, rows, BS_EOS, temperature, lp)
    torch.cuda.synchronize()
    assert bs.launches - before == 2 * _bs_launches(b, k, v)
    assert all(torch.equal(a, e) for a, e in zip(got, again))
    want = bs.select_plain(logits, scores, finished, rows, BS_EOS, temperature, lp)
    sep = _bs_separated(logits, scores, finished, BS_EOS, temperature, lp, k)
    assert int(sep.sum()) >= max(1, int(0.9 * b)), "too few lines to compare"
    for a, e in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert a.dtype == e.dtype and a.shape == (b, k)
        assert torch.equal(a[sep], e[sep])
    s, w = got[2][sep], want[2][sep]
    assert float(((s - w).abs() / w.abs().clamp_min(1e-30)).max()) <= 2e-6
    parent, tok, _, fin = got
    assert bool((tok[0] == BS_EOS).all()) and bool(fin[0].all())  # line 0 had finished
    assert not bool((finished.gather(1, parent) & (tok != BS_EOS)).any())
    assert bool((fin == (finished.gather(1, parent) | (tok == BS_EOS))).all())


@pytest.mark.parametrize("b, k, v", BS_CASES)
def test_beam_select_kernel_resolves_exact_ties_to_the_lowest_flat_index(cuda, b, k, v):
    """Integer logits, each value many times in a row, and a beam that
    copies beam 0 (row and score): the kept beams are exactly those of the
    plain version on the CPU, whose log-softmax gives equal rows equal
    values (the card's composed ops need not, by the rows' alignment),
    their scores within 2e-6 of the plain version's on the card, and among
    equal scores the flat index rises."""
    from manuscript_tpu_torch.ops import beam_select as bs

    logits, scores, finished = _bs_state(cuda, b, k, v, seed=7 * b + k, integer=True)
    finished[1:] = False
    rows = torch.arange(b, device=cuda)[:, None]
    got = bs.beam_select(logits, scores, finished, rows, BS_EOS, 1.0, None)
    torch.cuda.synchronize()
    cpu = [t.cpu() for t in (logits, scores, finished, rows)]
    want = bs.select_plain(*cpu, BS_EOS, 1.0, None)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    on_card = bs.select_plain(logits, scores, finished, rows, BS_EOS, 1.0, None)
    torch.testing.assert_close(got[2], on_card[2], rtol=2e-6, atol=0)
    flat, top = got[0] * v + got[1], got[2]
    same = top[:, 1:] == top[:, :-1]
    assert bool(same.any()), "no tie was planted among the kept beams"
    assert bool((flat[:, 1:] > flat[:, :-1])[same].all())  # among equal scores, rising index


def test_beam_select_refuses_what_it_does_not_take(cuda):
    from manuscript_tpu_torch.ops import beam_select as bs

    logits, scores, finished = _bs_state(cuda, 2, 4, 30, seed=1)
    rows = torch.arange(2, device=cuda)[:, None]
    before = bs.launches
    cases = [
        ((logits.double(), scores, finished), "float32 matrix"),
        ((logits.t().contiguous().t(), scores, finished), "float32 matrix"),
        ((logits.reshape(2, 4, 30), scores, finished), "float32 matrix"),
        ((logits, scores.double(), finished), "scores must be"),
        ((logits, scores, finished.int()), "finished must be"),
        ((logits, scores, finished.cpu()), "finished must be"),
        ((logits[:6], scores, finished), "logits of shape"),
    ]
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            bs.beam_select(*args, rows, BS_EOS, 1.0, None)
    with pytest.raises(ValueError, match="beams a line"):
        bs.beam_select(torch.zeros(34, 30, device=cuda), torch.zeros(2, 17, device=cuda),
                       torch.zeros(2, 17, dtype=torch.bool, device=cuda), rows, 0, 1.0, None)
    with pytest.raises(ValueError, match="EOS"):
        bs.beam_select(logits, scores, finished, rows, 30, 1.0, None)
    assert bs.launches == before


def test_the_recognizers_beams_take_k8_at_every_step(cuda):
    """TRBA's and TrOCR's beams on the card at small widths: one K8 call a
    step, one launch for TRBA's short lines, two for TrOCR's 4 × 50,265."""
    from manuscript_tpu_torch.models.trocr import TrOCRConfig
    from manuscript_tpu_torch.ops import beam_select as bs
    from manuscript_tpu_torch.recognizers.trba import TRBA
    from manuscript_tpu_torch.recognizers.trocr import TrOCR

    trba = TRBA(device="cuda", allow_random_init=True, seed=5, max_length=7, hidden_size=64,
                img_h=32, img_w=64, cnn_stage_plan="micro")  # K1 takes H a multiple of 64
    crops = torch.randint(0, 256, (4, 32, 64, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(1)).to(cuda)
    before = bs.launches
    with torch.inference_mode():
        trba.recognize_tensor(crops, "beam", 3, 0.9, 1.7)
    torch.cuda.synchronize()
    assert bs.launches - before == 7
    cfg = TrOCRConfig(image_size=32, patch_size=8, enc_hidden=32, enc_layers=1, enc_heads=4,
                      enc_mlp=64, d_model=48, dec_layers=1, dec_heads=4, dec_ffn=96,
                      max_position_embeddings=40)
    trocr = TrOCR(device="cuda", allow_random_init=True, config=cfg, max_length=5)
    lines = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(2)).to(cuda)
    before = bs.launches
    with torch.inference_mode():
        trocr.recognize_tensor(lines, "beam", 4, 0.9, 1.0)
    torch.cuda.synchronize()
    assert bs.launches - before == 5 * 2
