"""The port's TRBA recognizer against the JAX package on the CPU, from the
committed ``trba_micro.msgpack`` (read by the port's own msgpack reader):
encoder output within 1e-4, greedy and beam tokens equal, confidences within
1e-4, on rendered word crops."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manuscript_tpu.recognizers.trba import TRBA as JaxTRBA, sequence_confidence as j_conf
from manuscript_tpu.utils.quality import QUALITY_DIR
from manuscript_tpu.utils.synthetic import VOCAB, render_word
from manuscript_tpu_torch.ops.image import resize_and_pad
from manuscript_tpu_torch.recognizers.trba import TRBA, sequence_confidence

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CKPT = QUALITY_DIR / "trba_micro.msgpack"


@pytest.fixture(scope="module")
def models():
    return JaxTRBA(model_path=str(CKPT)), TRBA(CKPT, device="cpu")


@pytest.fixture(scope="module")
def crops(models):
    rng = np.random.default_rng(0)
    words = [str(VOCAB[int(i)]) for i in rng.integers(len(VOCAB), size=6)]
    rec = models[1]
    batch = np.stack([resize_and_pad(render_word(w, rng, height=32), rec.img_h, rec.img_w)
                      for w in words])
    return batch, (batch.astype(np.float32) / 255.0 - 0.5) / 0.5


def test_config_and_charset_come_from_the_checkpoint(models):
    jax_rec, rec = models
    assert (rec.max_length, rec.hidden_size, rec.img_h, rec.img_w, rec.cnn_stage_plan) == (
        jax_rec.max_length, jax_rec.hidden_size, jax_rec.img_h, jax_rec.img_w,
        jax_rec.cnn_stage_plan)
    assert rec.itos == jax_rec.itos
    assert (rec.eos_id, rec.pad_id, rec.blank_id) == (jax_rec.eos_id, jax_rec.pad_id, jax_rec.blank_id)


def test_encoder_matches_jax(models, crops):
    jax_rec, rec = models
    ref = jax_rec.model.apply(jax_rec.variables, jnp.asarray(crops[1]), method="encode")
    with torch.no_grad():
        got = rec.model.encode(torch.from_numpy(crops[1]))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_decode_matches_jax(models, crops, mode):
    jax_rec, rec = models
    x = jnp.asarray(crops[1])
    if mode == "greedy":
        jl, jp = jax_rec.model.apply(jax_rec.variables, x, max_len=rec.max_length, method="greedy")
    else:
        jl, jp = jax_rec.model.apply(
            jax_rec.variables, x, max_len=rec.max_length, beam_size=8, alpha=0.9,
            temperature=1.7, method="beam",
        )
    jp, jc = j_conf(jl, jp, jax_rec.eos_id)
    preds, confs = rec.recognize_u8(crops[0], mode=mode, beam_size=8)
    np.testing.assert_array_equal(preds, np.asarray(jp))
    np.testing.assert_allclose(confs, np.asarray(jc), atol=1e-4, rtol=0)
    texts = [rec.decode(p) for p in preds]
    assert sum(bool(t) for t in texts) >= 4  # the trained model reads the words


def test_predict_wrapper_matches_jax(models, crops):
    jax_rec, rec = models
    imgs = [c for c in crops[0][:3]]
    ref = jax_rec.predict(imgs, batch_size=3)
    got = rec.predict(imgs)
    assert [r["text"] for r in got] == [r["text"] for r in ref]
    np.testing.assert_allclose([r["confidence"] for r in got], [r["confidence"] for r in ref], atol=1e-4)


def test_sequence_confidence_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 6, 9)).astype(np.float32)
    preds = rng.integers(0, 9, (4, 6)).astype(np.int64)
    preds[0, 2] = 2
    preds[1] = 3  # no EOS
    _, ref = j_conf(jnp.asarray(logits), jnp.asarray(preds), 2)
    _, got = sequence_confidence(torch.from_numpy(logits), torch.from_numpy(preds), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
