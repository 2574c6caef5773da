"""The plain references against the port, at tiny sizes on the CPU, from
one set of weights."""

import numpy as np
import pytest
import torch

from perfbench.drivers.east_train import make_pages
from perfbench.drivers.recognize import make_strips
from perfbench.reference import east as east_ref
from perfbench.reference import trba as trba_ref
from perfbench.tests.conftest import EAST_TINY, TRAIN_TINY, TRBA_TINY
from perfbench.weights import layout_of, make_weights

TRBA_CFG = {**TRBA_TINY, "num_classes": 194, "temperature": 1.7, "alpha": 0.9, "sos_id": 1, "eos_id": 2}


def test_the_trba_reference_follows_the_ports_model():
    from manuscript_tpu_torch.models.trba import TRBAModel
    from manuscript_tpu_torch.recognizers.trba import sequence_confidence

    w = make_weights(trba_ref.layout(TRBA_CFG), 4, "cpu")
    model = TRBAModel(194, 64, 1, 2, None, "micro").eval()
    assert layout_of(model) == trba_ref.layout(TRBA_CFG)
    model.load_state_dict(w)
    strips = make_strips(5, 32, 128, 0.35, 4, "cpu")
    x = (strips.float() / 255.0 - 0.5) / 0.5
    with torch.no_grad():
        enc = trba_ref.encode(w, TRBA_CFG, strips)
        torch.testing.assert_close(enc, model.encode(x), rtol=1e-5, atol=1e-6)
        steps, k = TRBA_CFG["max_length"], TRBA_CFG["beam_size"]
        logits, tokens = model.beam(x, steps, k, 0.9, 1.7)
        lp = trba_ref.forced_log_probs(w, TRBA_CFG, enc, tokens)
        torch.testing.assert_close(lp, torch.log_softmax(logits, -1), rtol=1e-5, atol=1e-5)
        _, conf = sequence_confidence(logits, tokens, 2)
        torch.testing.assert_close(trba_ref.path_confidence(lp, tokens, 2), conf.clamp(0, 1))
        best, ref_tokens = trba_ref.beam_search(w, TRBA_CFG, enc)
        assert torch.equal(ref_tokens, tokens)
        torch.testing.assert_close(best, trba_ref.path_log_prob(lp, tokens, 2), rtol=1e-6, atol=1e-4)
        # one beam is greedy decoding, whose paths score below the beam's best
        _, greedy = model.greedy(x, steps)
        greedy_lp = trba_ref.path_log_prob(trba_ref.forced_log_probs(w, TRBA_CFG, enc, greedy[:, :steps]),
                                           greedy[:, :steps], 2)
        assert float((best - greedy_lp).max()) > 1e-3


def test_the_east_reference_follows_the_ports_model_and_loss():
    from manuscript_tpu_torch.models.east import EASTModel
    from manuscript_tpu_torch.train.east_train import east_train_loss

    cfg = {**EAST_TINY, "use_ohem": True, "ohem_ratio": 0.5, "use_focal_geo": True, "focal_gamma": 2.0}
    w = make_weights(east_ref.layout(cfg), 6, "cpu")
    model = EASTModel("resnet50-micro").train()
    model.load_state_dict(w)
    images, score, geo = make_pages(2, 128, 0.25, TRAIN_TINY, 6, "cpu")
    assert score.sum() > 0 and geo.abs().sum() > 0
    x = (images.float() / 255.0 - 0.5) / 0.5
    out = model(x)
    s_ref, g_ref = east_ref.forward(w, cfg, images)
    torch.testing.assert_close(s_ref, out["score"][..., 0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(g_ref, out["geometry"], rtol=1e-4, atol=1e-4)
    small = torch.nn.functional.interpolate(images.permute(0, 3, 1, 2).float(), size=(96, 96),
                                            mode="bilinear", antialias=True).permute(0, 2, 3, 1)
    small = small.clamp(0, 255).to(torch.uint8)  # a multiscale side: maps resized to the labels
    for img in (images, small):
        want = east_ref.loss(w, cfg, img, score, geo)
        got = east_train_loss(model, img, score, geo, True, 0.5, True, 2.0)
        assert float(want.detach()) == pytest.approx(float(got.detach()), rel=1e-5)


def test_the_learning_rate_follows_the_ports_schedule():
    from manuscript_tpu_torch.train.optim import cosine_warm_restarts

    cfg = {"lr": 1e-3, "t_0": 10, "eta_min_ratio": 0.01}
    sched = cosine_warm_restarts(1e-3, 10, 8)
    for count in (0, 1, 2, 3, 79, 80, 81, 500, 2000):
        assert east_ref.learning_rate(cfg, count, 8) == pytest.approx(sched(count), rel=1e-6)


def test_the_weights_are_drawn_from_the_seed_alone():
    layout = {"a.weight": (8, 4, 3, 3), "a.bias": (8,), "bn.running_var": (8,), "k_kernel": (16, 4)}
    one, two = make_weights(layout, 9, "cpu"), make_weights(layout, 9, "cpu")
    assert all(torch.equal(one[k], two[k]) for k in layout)
    assert not torch.equal(one["a.weight"], make_weights(layout, 10, "cpu")["a.weight"])
    assert float(one["a.weight"].std()) == pytest.approx(36 ** -0.5, rel=0.3)
    assert float(one["k_kernel"].std()) == pytest.approx(16 ** -0.5, rel=0.3)
    assert abs(float(one["bn.running_var"].mean()) - 1.0) < 0.1
    assert np.isfinite(one["a.bias"].numpy()).all()
