"""The port's training losses and recognition/detection metrics against the
JAX package's, on the same numpy inputs from a seed: every loss within 1e-6
relative (1e-7 absolute near zero), its gradient where the JAX tests check
it, and the metrics equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manuscript_tpu.train import losses as J
from manuscript_tpu.train import metrics as JM
from manuscript_tpu_torch.train import losses as P
from manuscript_tpu_torch.train import metrics as PM

RTOL, ATOL = 1e-6, 1e-7


def _maps(seed: int, b: int = 2, h: int = 12, w: int = 10, empty: bool = False):
    rng = np.random.default_rng(seed)
    gt = (rng.uniform(size=(b, h, w)) < 0.3).astype(np.float32) * (not empty)
    pred = rng.uniform(0.01, 0.99, (b, h, w)).astype(np.float32)
    gt_geo = rng.normal(0, 4, (b, h, w, 8)).astype(np.float32)
    pred_geo = (gt_geo + rng.normal(0, 1.5, (b, h, w, 8))).astype(np.float32)
    return gt, pred, gt_geo, pred_geo


def _close(got: torch.Tensor, ref) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_dice_loss_and_soft_dice(seed):
    gt, pred, _, _ = _maps(seed)
    _close(P.dice_loss(torch.from_numpy(gt), torch.from_numpy(pred)), J.dice_loss(gt, pred))
    _close(P.soft_dice_coefficient(torch.from_numpy(gt), torch.from_numpy(pred)),
           J.soft_dice_coefficient(gt, pred))


@pytest.mark.parametrize("ohem,focal,four_d", [
    (False, False, False), (True, False, False), (False, True, False), (True, True, False),
    (True, True, True),
])
def test_east_loss(ohem, focal, four_d):
    gt, pred, gt_geo, pred_geo = _maps(3)
    if four_d:
        gt, pred = gt[..., None], pred[..., None]
    kw = dict(use_ohem=ohem, ohem_ratio=0.3, use_focal_geo=focal, focal_gamma=2.0)
    got = P.east_loss(*(torch.from_numpy(a) for a in (gt, pred, gt_geo, pred_geo)), **kw)
    _close(got, J.east_loss(gt, pred, gt_geo, pred_geo, **kw))


def test_east_loss_gradient():
    gt, pred, gt_geo, pred_geo = _maps(4)
    logits = np.log(pred / (1 - pred)).astype(np.float32)
    kw = dict(use_ohem=True, ohem_ratio=0.5, use_focal_geo=True)

    def jf(lg, pg):
        return J.east_loss(gt, jax.nn.sigmoid(lg), gt_geo, pg, **kw)

    jl, jg = jax.value_and_grad(jf, argnums=(0, 1))(logits, pred_geo)
    lg = torch.from_numpy(logits).requires_grad_()
    pg = torch.from_numpy(pred_geo).requires_grad_()
    loss = P.east_loss(torch.from_numpy(gt), torch.sigmoid(lg), torch.from_numpy(gt_geo), pg, **kw)
    loss.backward()
    _close(loss, jl)
    for got, ref in ((lg.grad, jg[0]), (pg.grad, jg[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)


def test_east_loss_without_positive_pixels_is_zero_with_a_defined_gradient():
    gt, pred, gt_geo, pred_geo = _maps(5, empty=True)
    lg = torch.zeros(pred.shape, requires_grad=True)
    loss = P.east_loss(torch.from_numpy(gt), torch.sigmoid(lg), torch.from_numpy(gt_geo),
                       torch.from_numpy(pred_geo), use_ohem=True, use_focal_geo=True)
    loss.backward()
    assert loss.item() == 0.0
    assert torch.isfinite(lg.grad).all()
    _close(loss, J.east_loss(gt, jax.nn.sigmoid(jnp.zeros(pred.shape)), gt_geo, pred_geo,
                             use_ohem=True, use_focal_geo=True))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trba_ce_loss(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, (4, 7, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (4, 7)).astype(np.int32)
    targets[:, 5:] = 0  # PAD
    if seed == 2:
        targets[:] = 0  # all PAD: the mean's denominator clamps to 1
    _close(P.trba_ce_loss(torch.from_numpy(logits), torch.from_numpy(targets), 0),
           J.trba_ce_loss(logits, targets, 0))


REFS = ["manuscript", "", "old page", "ink", "a b c", ""]
HYPS = ["manuscrpt", "x", "old page", "", "a c", ""]


@pytest.mark.parametrize("ref,hyp", list(zip(REFS, HYPS)))
def test_cer_and_wer(ref, hyp):
    assert PM.character_error_rate(ref, hyp) == JM.character_error_rate(ref, hyp)
    assert PM.word_error_rate(ref, hyp) == JM.word_error_rate(ref, hyp)


def test_accuracy_and_aggregate():
    assert PM.compute_accuracy(REFS, HYPS) == JM.compute_accuracy(REFS, HYPS)
    assert PM.compute_accuracy([], []) == JM.compute_accuracy([], [])
    assert PM.aggregate_text_metrics(REFS, HYPS) == JM.aggregate_text_metrics(REFS, HYPS)


def test_detection_f1_metrics():
    rng = np.random.default_rng(7)
    gt, preds = {}, []
    for iid in range(3):
        boxes = [rng.uniform(0, 200, 2) for _ in range(4)]
        gt[iid] = [[x, y, x + 40, y, x + 40, y + 15, x, y + 15] for x, y in boxes]
        for x, y in boxes[:3]:
            dx = rng.uniform(-8, 8)
            preds.append({"image_id": iid,
                          "segmentation": [x + dx, y, x + 40, y, x + 40, y + 15, x + dx, y + 15]})
    got = PM.compute_f1_metrics(preds, gt, list(gt))
    ref = JM.compute_f1_metrics(preds, gt, list(gt))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=1e-9)
