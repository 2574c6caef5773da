"""The beam's advance (``ops/beam_select.py``, K8) on the CPU: its plain
version bit-equal to the composed ops that ``Beam.advance`` ran before the
selection moved there (kept here verbatim as ``_composed``), the trace of
raw logits and the backtrace's division bit-equal to the earlier trace of
divided logits (``_EarlierBeam``), ties, finished beams, and the kernels'
plan, width, cost, key order and refusals."""

import struct

import pytest
import torch

from manuscript_tpu_torch.models.beam import Beam, length_scale
from manuscript_tpu_torch.ops import beam_select as bs

NEG_INF = -1e30


def _composed(logits, scores, finished, rows, eos_id, t, alpha, temperature):
    """``Beam.advance``'s body before K8 → (parent, tok, scores, finished, scaled logits)."""
    b, k = scores.shape
    v = logits.shape[-1]
    logits = logits / max(temperature, 1e-6)
    log_probs = torch.log_softmax(logits, dim=-1).reshape(b, k, v)
    log_probs = torch.where(finished[:, :, None], torch.full_like(log_probs, NEG_INF), log_probs)
    log_probs[..., eos_id] = torch.where(finished, torch.zeros_like(scores), log_probs[..., eos_id])
    next_scores = scores[:, :, None] + log_probs
    lp = 1.0
    if alpha > 0:
        lp = length_scale(t, alpha)
        next_scores = next_scores / lp
    top_scores, top_idx = bs.topk_lowest_index(next_scores.reshape(b, k * v), k)
    parent = top_idx // v
    tok = top_idx % v
    finished = finished[rows, parent] | (tok == eos_id)
    return parent, tok, top_scores * lp if alpha > 0 else top_scores, finished, logits


class _EarlierBeam(Beam):
    """The beam before K8: the trace kept the logits divided by T."""

    def advance(self, logits, t, alpha, temperature):
        self.parent, self.tok, self.scores, self.finished, scaled = _composed(
            logits, self.scores, self.finished, self.rows, self.eos_id, t, alpha, temperature)
        self.trace.append((self.tok, self.parent, scaled.reshape(self.b, self.k, self.v)))
        return self.parent

    def backtrace(self):
        beam = torch.argmax(self.scores, dim=-1)
        b1 = self.rows[:, 0]
        tokens, out_logits = [], []
        for tok_t, par_t, log_t in reversed(self.trace):
            tokens.append(tok_t[b1, beam])
            beam = par_t[b1, beam]
            out_logits.append(log_t[b1, beam])
        return torch.stack(out_logits[::-1], 1), torch.stack(tokens[::-1], 1)


def _state(b, k, v, seed, finished_share=0.3, ties=False):
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(b * k, v, generator=g) * 3
    if ties:  # duplicate rows across beams and repeated values within a row
        logits = logits.reshape(b, k, v)
        logits[:, k // 2] = logits[:, 0]
        logits[..., v // 2:] = logits[..., :v - v // 2].clone()
        logits = logits.reshape(b * k, v).round()
    scores = -torch.rand(b, k, generator=g) * 5
    if ties:
        scores[:, k // 2] = scores[:, 0]
    finished = torch.rand(b, k, generator=g) < finished_share
    finished[0] = True  # a line whose every beam has finished
    return logits, scores, finished


CASES = [(3, 4, 50, 3), (2, 8, 194, 2), (5, 1, 30, 0), (1, 16, 17, 16)]


@pytest.mark.parametrize("b, k, v, eos", CASES)
@pytest.mark.parametrize("alpha, temperature", [(0.0, 1.0), (0.9, 1.0), (0.9, 1.7), (0.0, 1.7)])
@pytest.mark.parametrize("ties", [False, True])
def test_the_plain_version_is_bit_equal_to_the_composed_advance(b, k, v, eos, alpha, temperature,
                                                                 ties):
    logits, scores, finished = _state(b, k, v, seed=b * 100 + k, ties=ties)
    rows = torch.arange(b)[:, None]
    for t in (0, 3):
        lp = length_scale(t, alpha) if alpha > 0 else None
        got = bs.beam_select(logits, scores, finished, rows, eos, temperature, lp)
        want = _composed(logits, scores, finished, rows, eos, t, alpha, temperature)[:4]
        for a, e in zip(got, want):
            assert a.dtype == e.dtype and a.shape == (b, k)
            assert torch.equal(a, e)


@pytest.mark.parametrize("temperature", [1.0, 1.7])
@pytest.mark.parametrize("alpha", [0.0, 0.9])
def test_the_raw_logit_trace_backtraces_bit_equal_to_the_divided_one(temperature, alpha):
    b, k, v, eos, steps = 4, 3, 40, 5, 7
    g = torch.Generator().manual_seed(int(temperature * 10) + int(alpha * 100))
    new, old = (cls(b, k, v, 1, eos, "cpu") for cls in (Beam, _EarlierBeam))
    for t in range(steps):
        logits = torch.randn(b * k, v, generator=g) * 4
        logits[:, eos] += 2.0 * (t > 2)  # beams start to finish
        assert torch.equal(new.advance(logits, t, alpha, temperature),
                           old.advance(logits, t, alpha, temperature))
        for name in ("tok", "scores", "finished"):
            assert torch.equal(getattr(new, name), getattr(old, name)), name
    assert bool(new.finished.any())
    got_logits, got_tokens = new.backtrace()
    want_logits, want_tokens = old.backtrace()
    assert torch.equal(got_tokens, want_tokens)
    assert torch.equal(got_logits, want_logits)


def test_ties_go_to_the_lowest_flat_index():
    """Two beams of one score and one row of logits; within a row every
    value twice: the kept beams are parent 0's copies first, each value's
    lower token first."""
    b, k, v = 1, 4, 6
    row = torch.tensor([2.0, 1.0, 2.0, 1.0, 0.0, 0.0])
    logits = torch.stack([row, row, row - 9, row - 9])
    scores = torch.tensor([[-1.0, -1.0, -1.0, -1.0]])
    parent, tok, top, _ = bs.beam_select(logits, scores, torch.zeros(b, k, dtype=torch.bool),
                                         torch.arange(b)[:, None], 5, 1.0, None)
    assert parent.tolist() == [[0, 0, 1, 1]]
    assert tok.tolist() == [[0, 2, 0, 2]]
    assert top[0, 0] == top[0, 3]


def test_finished_beams_continue_only_with_eos():
    b, k, v, eos = 2, 3, 10, 7
    logits = torch.randn(b * k, v, generator=torch.Generator().manual_seed(3))
    scores = torch.tensor([[-1.0, -3.0, -2.0], [-0.5, -4.0, -6.0]])
    finished = torch.tensor([[True, True, True], [False, True, False]])
    parent, tok, top, fin = bs.beam_select(logits, scores, finished, torch.arange(b)[:, None],
                                           eos, 1.0, None)
    # a line whose every beam has finished keeps them, by score, each with EOS
    assert parent[0].tolist() == [0, 2, 1] and tok[0].tolist() == [eos] * 3
    assert torch.equal(top[0], torch.tensor([-1.0, -2.0, -3.0])) and bool(fin[0].all())
    # the finished beam 1 of line 1 offers EOS at its own score, nothing else
    assert not ((parent[1] == 1) & (tok[1] != eos)).any()


@pytest.mark.parametrize("lines, k, v, sms", [
    (512, 8, 194, 132), (128, 4, 50265, 132), (1, 4, 50265, 132), (3, 8, 194, 132),
    (4096, 4, 50265, 132), (2, 16, 1000, 132), (7, 3, 100003, 8), (1, 1, 8193, 132),
])
def test_the_plan_covers_each_line_once(lines, k, v, sms):
    kv = k * v
    pl = bs.plan(lines, k, v, sms)
    assert pl.chunk % 4 == 0 or pl.chunks == 1
    assert (pl.chunks - 1) * pl.chunk < kv <= pl.chunks * pl.chunk  # no empty chunk, every value
    if kv <= bs.LINE_VALUES:
        assert pl == bs.Plan(False, kv, 1)  # one launch: TRBA's 8 × 194
    else:
        assert pl.two and (pl.chunks == 1 or pl.chunk >= bs.CHUNK_MIN)
        assert lines * pl.chunks >= min(bs.WAVE * sms, lines * (kv // bs.CHUNK_MIN))


def test_the_trocr_cells_plan_and_cost():
    assert bs.plan(128, 4, 50265, 132) == bs.Plan(True, 40212, 5)
    ops, nbytes = bs.cost(128, 4, 50265)
    assert nbytes == 4 * 512 * 50265 + 512 * 26
    assert ops == 9 * 512 * 50265


@pytest.mark.parametrize("k, want", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (8, 8), (9, 16),
                                     (16, 16)])
def test_width(k, want):
    assert bs.width(k) == want


def _key(v: float, i: int) -> int:
    """csrc/beam_select.cu's key_of in Python."""
    v = v + 0.0
    u = struct.unpack("<I", struct.pack("<f", v))[0]
    if v != v:
        u = 0x7FC00000
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (u << 32) | (0xFFFFFFFF - i)


def test_the_kernels_key_orders_as_the_stable_descending_sort():
    x = torch.tensor([0.0, -0.0, float("nan"), 1.0, float("inf"), -float("inf"), float("nan"),
                      -0.0, 0.0, 1.0, -1e30, -2e30, 3.5e-45, -3.5e-45, 1.0000001])
    _, want = torch.sort(x, descending=True, stable=True)
    got = sorted(range(len(x)), key=lambda i: -_key(float(x[i]), i))
    assert got == want.tolist()


def test_beam_select_refuses_a_device_without_the_kernels():
    t = torch.zeros(4, 5, device="meta")
    with pytest.raises(ValueError, match="CUDA card"):
        bs.beam_select(t, torch.zeros(2, 2, device="meta"),
                       torch.zeros(2, 2, dtype=torch.bool, device="meta"), None, 0, 1.0, None)


def _regions(prof):
    cpu = torch.autograd.DeviceType.CPU
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == cpu and e.is_user_annotation]


def _inside(regions, name, outer):
    return [r for r in regions if r[0] == name and outer[1] <= r[1] and r[2] <= outer[2]]


@pytest.mark.parametrize("recognizer", ["trba", "trocr"])
def test_each_beam_step_opens_one_advance_span(recognizer, tmp_path):
    """``beam.advance`` (read by ``beam_advance_ms``) once inside each
    ``beam.step`` (TRBA) or ``trocr.step`` (TrOCR), and nowhere else."""
    from manuscript_tpu_torch.models.trocr import TrOCRConfig
    from manuscript_tpu_torch.recognizers import TRBA, TrOCR
    from manuscript_tpu_torch.utils import profiling

    if recognizer == "trba":
        rec = TRBA(device="cpu", allow_random_init=True, max_length=5, hidden_size=16,
                   img_h=32, img_w=64, cnn_stage_plan="micro")
        crops, step = torch.randint(0, 256, (3, 32, 64, 3), dtype=torch.uint8), "beam.step"
    else:
        cfg = TrOCRConfig(image_size=32, patch_size=8, enc_hidden=32, enc_layers=1, enc_heads=4,
                          enc_mlp=64, d_model=48, dec_layers=1, dec_heads=4, dec_ffn=96,
                          vocab_size=300, max_position_embeddings=40)
        rec = TrOCR(device="cpu", allow_random_init=True, config=cfg, max_length=5)
        crops, step = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8), "trocr.step"
    with profiling.trace(tmp_path) as prof:
        rec.recognize_tensor(crops, "beam", beam_size=3)
    regions = _regions(prof)
    steps = [r for r in regions if r[0] == step]
    assert len(steps) == 5
    assert all(len(_inside(regions, "beam.advance", s)) == 1 for s in steps)
    assert len([r for r in regions if r[0] == "beam.advance"]) == 5
