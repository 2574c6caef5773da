"""TrOCR in the port (``models/trocr.py``, ``recognizers/trocr.py``) against
its plain reference (``perfbench/reference/trocr.py``: whole sequences
under a causal mask, no cache, a beam search that reruns every prefix) on
the CPU, at a small size, on seeded random weights named as the port's
``state_dict()`` names them.

Tolerances: the encoder's output within 2e-5 and the logits within 5e-5
absolute (float32 on both sides, the same operations summed in another
order: matrix products blocked differently, the cached step's attention
over one row at a time); the beam's path at most 1e-5 nats below the
reference's best (the same rules, so only a near-tie that rounding flips
could part them, and at this size there is none)."""

import numpy as np
import pytest
import torch

from manuscript_tpu_torch import Pipeline
from manuscript_tpu_torch.models.trocr import TrOCRConfig, TrOCRModel
from manuscript_tpu_torch.recognizers import TRBA, TrOCR
from manuscript_tpu_torch.recognizers.trocr import stand_in_vocab
from manuscript_tpu_torch.types import Block, Page, Word
from manuscript_tpu_torch.utils.quality import load_quality_models as port_models
from perfbench.precision import plain_float32
from perfbench.reference import trocr as ref
from perfbench.weights import layout_of, make_weights

HF = {  # a vision-encoder-decoder config.json at a small size
    "decoder_start_token_id": 2,
    "encoder": {"image_size": 32, "patch_size": 8, "num_channels": 3, "hidden_size": 32,
                "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 64,
                "layer_norm_eps": 1e-12, "qkv_bias": False, "hidden_act": "gelu"},
    "decoder": {"d_model": 48, "decoder_layers": 2, "decoder_attention_heads": 4,
                "decoder_ffn_dim": 96, "vocab_size": 300, "max_position_embeddings": 40,
                "cross_attention_hidden_size": 32, "decoder_start_token_id": 2, "bos_token_id": 0,
                "pad_token_id": 1, "eos_token_id": 2, "scale_embedding": False,
                "layernorm_embedding": True, "use_learned_position_embeddings": True,
                "activation_function": "gelu"},
}
CFG = {**HF, "beam_size": 3, "alpha": 0.9, "temperature": 1.0, "max_length": 8}
SEED = 2**31 + 17


@pytest.fixture(scope="module")
def trocr():
    rec = TrOCR(device="cpu", allow_random_init=True, max_length=CFG["max_length"],
                config=TrOCRConfig.from_hf(HF))
    weights = make_weights(ref.layout(CFG), SEED, "cpu")
    rec.model.load_state_dict(weights)
    return rec, weights


@pytest.fixture(scope="module")
def lines():
    return torch.randint(0, 256, (5, 32, 32, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(3))


def test_the_published_widths_hold_333m_parameters_named_as_the_reference_names_them():
    with torch.device("meta"):
        model = TrOCRModel()
    assert sum(p.numel() for p in model.parameters()) == 333_331_200
    assert sum(p.numel() for n, p in model.named_parameters() if n.startswith("encoder.")) == 86_062_848
    published = {**HF, "encoder": {**HF["encoder"], "image_size": 384, "patch_size": 16,
                                   "hidden_size": 768, "num_hidden_layers": 12,
                                   "num_attention_heads": 12, "intermediate_size": 3072},
                 "decoder": {**HF["decoder"], "d_model": 1024, "decoder_layers": 12,
                             "decoder_attention_heads": 16, "decoder_ffn_dim": 4096,
                             "vocab_size": 50265, "max_position_embeddings": 512,
                             "cross_attention_hidden_size": 768}}
    assert TrOCRConfig.from_hf(published) == TrOCRConfig()
    assert layout_of(model) == ref.layout(published)


def test_a_variant_the_model_does_not_build_is_refused():
    with pytest.raises(ValueError, match="qkv_bias"):
        TrOCRConfig.from_hf({**HF, "encoder": {**HF["encoder"], "qkv_bias": True}})


def test_the_encoder_follows_the_reference(trocr, lines):
    rec, w = trocr
    with plain_float32(), torch.no_grad():
        got = rec.model.encode((lines.float() / 255.0 - 0.5) / 0.5)
        want = ref.encode(w, CFG, lines)
    assert got.shape == (5, 17, 32)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("k", [1, 3])
def test_the_cached_step_follows_the_teacher_forced_reference_at_every_step(trocr, lines, k):
    """k rows a line share the line's cross-attention cache, each on a path
    of its own; every step's logits against the reference's whole-sequence
    logits at that position."""
    rec, w = trocr
    steps = 6
    ids = torch.randint(0, 300, (5 * k, steps), generator=torch.Generator().manual_seed(k))
    ids[:, 0] = 2
    with plain_float32(), torch.no_grad():
        enc = ref.encode(w, CFG, lines)
        want = ref.decoder_logits(w, CFG, enc.repeat_interleave(k, 0), ids)
        cross = rec.model.cross_kv(enc)
        cache = rec.model.new_cache(5 * k, steps, enc)
        got = torch.stack([rec.model.step(ids[:, t], t, cache, cross, k) for t in range(steps)], 1)
        forward = rec.model(enc.repeat_interleave(k, 0), ids)
    torch.testing.assert_close(got, want, atol=5e-5, rtol=0)
    torch.testing.assert_close(forward, want, atol=5e-5, rtol=0)


def test_the_beam_path_is_the_references_best_and_its_logits_are_the_references(trocr, lines):
    rec, w = trocr
    with plain_float32():
        ids, conf, logits = rec.recognize_tensor(lines, "beam", CFG["beam_size"], CFG["alpha"],
                                                 CFG["temperature"], return_logits=True)
        enc = ref.encode(w, CFG, lines)
        lp = ref.forced_log_probs(w, CFG, enc, ids)
        best, best_tokens = ref.beam_search(w, CFG, enc)
    assert ids.shape == (5, CFG["max_length"]) and logits.shape == (5, CFG["max_length"], 300)
    gap = best - ref.path_log_prob(lp, ids, 2)
    assert float(gap.max()) <= 1e-5
    torch.testing.assert_close(torch.log_softmax(logits, -1), lp, atol=5e-5, rtol=0)
    torch.testing.assert_close(conf, ref.path_confidence(lp, ids, 2), atol=1e-6, rtol=0)
    assert [rec.decode(r) for r in ids] == [ref.stand_in_text(r.tolist(), 2) for r in ids]
    greedy, _ = rec.recognize_tensor(lines, "greedy")
    assert greedy.shape == ids.shape


def test_the_stand_in_vocabulary_and_decode():
    vocab = stand_in_vocab(50265)
    assert len(vocab) == 50265 == len(set(vocab))
    assert vocab[:5] == ["<s>", "<pad>", "</s>", "<unk>", " "]
    assert vocab[98] == "~" and vocab[99] == " !"
    rec = TrOCR(device="cpu", allow_random_init=True, config=TrOCRConfig.from_hf(HF))
    assert rec.decode([0, 37, 1, 38, 3, 2, 40]) == "AB"


def test_predict_resizes_each_line_and_returns_texts(trocr):
    rec, _ = trocr
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((20, 90), (45, 300), (32, 32))]
    out = rec.predict(images, batch_size=2)
    assert len(out) == 3 and all(isinstance(r["text"], str) and 0 <= r["confidence"] <= 1 for r in out)
    x = torch.stack([torch.from_numpy(rec._preprocess_one(im)) for im in images])
    ids, conf = rec.recognize_tensor(x)
    assert [r["text"] for r in out] == [rec.decode(r) for r in ids]


class _Lines:
    """A detector that finds two lines on any page."""

    def predict(self, image, vis=False, profile=False):
        return {"page": Page(blocks=[Block(words=[
            Word(polygon=[(4, 4), (120, 4), (120, 30), (4, 30)], detection_confidence=0.9),
            Word(polygon=[(4, 40), (90, 40), (90, 70), (4, 70)], detection_confidence=0.8)])])}


def test_the_pipeline_reads_with_trocr_on_the_classic_route(trocr):
    rec, _ = trocr
    pipe = Pipeline(_Lines(), rec, device="cpu", beam_size=2, temperature=1.0)
    assert pipe._fused is None
    page = pipe.predict(np.full((80, 128, 3), 200, dtype=np.uint8))
    words = [w for b in page.blocks for w in b.words]
    assert len(words) == 2 and all(isinstance(w.text, str) for w in words)
    assert all(0 <= w.recognition_confidence <= 1 for w in words)


def test_fused_auto_sends_trocr_to_the_classic_route_and_true_refuses_it(trocr):
    rec, _ = trocr
    east, _ = port_models("cpu")
    assert Pipeline(east, rec, device="cpu")._fused is None
    with pytest.raises(ValueError, match="fused=True needs the port's EAST"):
        Pipeline(east, rec, device="cpu", fused=True)


def test_a_checkpoint_by_hugging_faces_names_loads_and_none_without_random_init_raises(trocr, tmp_path):
    rec, weights = trocr
    state = {**weights, "decoder.output_projection.weight": weights[f"{ref.DEC}.embed_tokens.weight"]}
    torch.save(state, tmp_path / "pytorch_model.bin")
    loaded = TrOCR(tmp_path / "pytorch_model.bin", device="cpu", config=rec.config)
    assert all(torch.equal(loaded.model.state_dict()[k], v) for k, v in weights.items())
    given = TrOCR(state, device="cpu", allow_random_init=False, config=rec.config)
    assert all(torch.equal(given.model.state_dict()[k], v) for k, v in weights.items())
    with pytest.raises(ValueError, match="no checkpoint"):
        TrOCR(device="cpu", allow_random_init=False, config=rec.config)


class _SpyModel:
    """A recognizer model that records the arguments of its decodes."""

    def __init__(self, vocab, eos_id):
        self.vocab, self.eos_id, self.calls = vocab, eos_id, []

    def _out(self, x, max_len):
        tokens = torch.full((x.shape[0], max_len), self.eos_id)
        return torch.zeros(x.shape[0], max_len, self.vocab), tokens

    def greedy(self, x, max_len):
        self.calls.append(("greedy", x.shape[0], max_len))
        return self._out(x, max_len)

    def beam(self, x, max_len, k, alpha, temperature):
        self.calls.append(("beam", x.shape[0], max_len, k, alpha, temperature))
        assert x.dtype == torch.float32 and -1.0 <= float(x.min()) <= float(x.max()) <= 1.0
        return self._out(x, max_len)


@pytest.mark.parametrize("name,defaults", [("trba", (8, 0.9, 1.7, 32)), ("trocr", (4, 0.9, 1.0, 16))])
def test_the_shared_surface_keeps_each_wrappers_defaults_and_calls_recognize_tensor(
        name, defaults, monkeypatch):
    """``predict`` with no decode arguments runs the wrapper's own beam, α,
    T and chunk size; every chunk goes through the class's
    ``recognize_tensor`` attribute (the benchmark's faults patch it there),
    and patching one wrapper's leaves the other's alone."""
    if name == "trba":
        rec = TRBA(device="cpu", allow_random_init=True, max_length=3, hidden_size=16,
                   img_h=32, img_w=64, cnn_stage_plan="micro")
        vocab, other = len(rec.itos), TrOCR
    else:
        rec = TrOCR(device="cpu", allow_random_init=True, max_length=3, config=TrOCRConfig.from_hf(HF))
        vocab, other = rec.config.vocab_size, TRBA
    k, alpha, temperature, batch = defaults
    assert (rec.BEAM_SIZE, rec.ALPHA, rec.TEMPERATURE, rec.BATCH_SIZE) == defaults
    rec.model = _SpyModel(vocab, rec.eos_id)
    chunks, inner = [], type(rec).recognize_tensor
    monkeypatch.setattr(type(rec), "recognize_tensor",
                        lambda self, crops, *args: chunks.append(crops.shape[0]) or inner(self, crops, *args))
    images = [np.full((20, 40, 3), 200, dtype=np.uint8)] * (batch + 1)
    out = rec.predict(images)
    assert len(out) == batch + 1 and chunks == [batch, 1]
    assert rec.model.calls == [("beam", batch, 3, k, alpha, temperature), ("beam", 1, 3, k, alpha, temperature)]
    assert other.recognize_tensor is not type(rec).recognize_tensor
    rec.recognize_u8(np.stack([rec._preprocess_one(images[0])]), "greedy")
    assert rec.model.calls[-1] == ("greedy", 1, 3) and chunks[-1] == 1
