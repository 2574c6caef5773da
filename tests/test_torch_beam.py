"""The shared beam bookkeeping (``models/beam.py``) under TRBA's decoder: a
seeded tiny TRBA's beam tokens and logits bit-equal to the loop that
``AttentionDecoder.beam`` ran before the bookkeeping moved out of it (kept
here verbatim as ``_beam_inline``), with as many operations a step."""

import pytest
import torch

from manuscript_tpu_torch.models.beam import NEG_INF, topk_lowest_index
from manuscript_tpu_torch.recognizers.trba import TRBA
from manuscript_tpu_torch.utils import profiling


def _beam_inline(self, enc, max_len=25, beam_size=5, alpha=0.9, temperature=1.7):
    b = enc.shape[0]
    k, v, hdim = beam_size, self.num_classes, self.hidden_size
    dev = enc.device
    enc, proj_enc = self._prepare(enc)
    bidx = torch.arange(b, device=dev)[:, None]
    tok = torch.full((b, k), self.sos_id, dtype=torch.int64, device=dev)
    scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    h = enc.new_zeros(b, k, hdim)
    c = enc.new_zeros(b, k, hdim)
    finished = torch.zeros(b, k, dtype=torch.bool, device=dev)
    trace = []
    for t in range(max_len):
        with profiling.annotate("beam.step"):
            h2, c2 = self._step(h.reshape(b * k, hdim), c.reshape(b * k, hdim), enc, proj_enc,
                                tok.reshape(b * k), beam=k)
            logits = self._logits(h2) / max(temperature, 1e-6)
            log_probs = torch.log_softmax(logits, dim=-1).reshape(b, k, v)
            log_probs = torch.where(finished[:, :, None], torch.full_like(log_probs, NEG_INF), log_probs)
            log_probs[..., self.eos_id] = torch.where(finished, torch.zeros_like(scores),
                                                      log_probs[..., self.eos_id])
            next_scores = scores[:, :, None] + log_probs
            lp = 1.0
            if alpha > 0:
                lp = float(torch.tensor(6.0 + t, dtype=torch.float32) ** alpha / (6.0**alpha))
                next_scores = next_scores / lp
            top_scores, top_idx = topk_lowest_index(next_scores.reshape(b, k * v), k)
            parent = top_idx // v
            tok = top_idx % v
            h = h2.reshape(b, k, hdim)[bidx, parent]
            c = c2.reshape(b, k, hdim)[bidx, parent]
            finished = finished[bidx, parent] | (tok == self.eos_id)
            scores = top_scores * lp if alpha > 0 else top_scores
            trace.append((tok, parent, logits.reshape(b, k, v)))
    beam = torch.argmax(scores, dim=-1)
    b1 = bidx[:, 0]
    tokens, out_logits = [], []
    for tok_t, par_t, log_t in reversed(trace):
        tokens.append(tok_t[b1, beam])
        beam = par_t[b1, beam]
        out_logits.append(log_t[b1, beam])
    return torch.stack(out_logits[::-1], 1), torch.stack(tokens[::-1], 1)


def _ops_a_step(prof):
    cpu = torch.autograd.DeviceType.CPU
    events = [e for e in prof.events() if e.device_type == cpu]
    steps = [e for e in events if e.name == "beam.step"]
    inside = [e for e in events if e.name.startswith("aten::") and any(
        s.time_range.start <= e.time_range.start and e.time_range.end <= s.time_range.end for s in steps)]
    assert inside and steps
    return sorted(e.name for e in inside), len(steps)


@pytest.mark.parametrize("alpha, temperature", [(0.9, 1.7), (0.0, 1.0)])
def test_trbas_beam_on_the_shared_bookkeeping_is_bit_equal_to_the_inline_loop(alpha, temperature, tmp_path):
    trba = TRBA(device="cpu", allow_random_init=True, seed=5, max_length=7, hidden_size=16,
                img_h=32, img_w=64, cnn_stage_plan="micro")
    crops = torch.randint(0, 256, (4, 32, 64, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        enc = trba.model.encode((crops.float() / 255.0 - 0.5) / 0.5)
        dec = trba.model.decoder
        with profiling.trace(tmp_path / "shared") as prof_shared:
            logits, tokens = dec.beam(enc, 7, 3, alpha, temperature)
        with profiling.trace(tmp_path / "inline") as prof_inline:
            want_logits, want_tokens = _beam_inline(dec, enc, 7, 3, alpha, temperature)
    assert torch.equal(tokens, want_tokens)
    assert torch.equal(logits, want_logits)
    assert _ops_a_step(prof_shared) == _ops_a_step(prof_inline)
