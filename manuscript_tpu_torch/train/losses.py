"""Training losses (counterpart of ``manuscript_tpu/train/losses.py``), in
torch ops with no data-dependent host branch.

EAST: dice on the score map plus per-pixel L1 summed over the 8 geometry
channels, masked by the ground-truth score map; optionally the focal weight
(1 − e^{−L})^γ, and OHEM as the mean of each sample's top-k pixels with a
static k; a batch with no positive pixel gives a zero loss whose gradient is
still defined. TRBA: token cross-entropy averaged over the non-PAD positions.

Each loss is a ratio of sums over the batch. Given a process ``group``
(data-parallel training, each rank holding a slice of the batch), every
numerator and denominator is summed over the ranks first
(``parallel.sum_over_ranks``, differentiable), so that each rank computes
the loss of the global batch, as the JAX package's GSPMD step does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.mesh import sum_over_ranks


def _global_sums(group, *sums: torch.Tensor):
    """The scalars ``sums``, each summed over the ranks of ``group`` in one
    all-reduce (themselves when ``group`` is None)."""
    if group is None:
        return sums
    return tuple(sum_over_ranks(torch.stack(sums), group).unbind())


def dice_loss(gt: torch.Tensor, pred: torch.Tensor, group=None) -> torch.Tensor:
    """1 − 2·|gt∩pred| / (|gt| + |pred|), global over the batch."""
    inter, s_gt, s_pred = _global_sums(group, torch.sum(gt * pred), torch.sum(gt), torch.sum(pred))
    return 1.0 - 2.0 * inter / (s_gt + s_pred + 1e-5)


def east_loss(
    gt_score: torch.Tensor,  # (B, H, W) or (B, H, W, 1)
    pred_score: torch.Tensor,
    gt_geo: torch.Tensor,  # (B, H, W, 8)
    pred_geo: torch.Tensor,
    use_ohem: bool = False,
    ohem_ratio: float = 0.5,
    use_focal_geo: bool = False,
    focal_gamma: float = 2.0,
    group=None,
) -> torch.Tensor:
    if gt_score.dim() == 4:
        gt_score = gt_score[..., 0]
    if pred_score.dim() == 4:
        pred_score = pred_score[..., 0]
    geo_map = torch.sum(torch.abs(gt_geo - pred_geo), dim=-1)  # (B, H, W)
    if use_focal_geo:
        geo_map = geo_map * (1.0 - torch.exp(-geo_map)) ** focal_gamma
    geo_map = geo_map * gt_score
    if use_ohem:  # the mean over rows of each row's top-k mean
        flat = geo_map.reshape(geo_map.shape[0], -1)
        k = max(int(ohem_ratio * flat.shape[1]), 1)
        geo_num = torch.sum(torch.mean(torch.topk(flat, k, dim=1).values, dim=1))
        geo_den = torch.tensor(float(flat.shape[0]), dtype=flat.dtype, device=flat.device)
    else:
        geo_num, geo_den = torch.sum(geo_map), None
    n_pos, inter, s_pred, geo_num, *rest = _global_sums(
        group, torch.sum(gt_score), torch.sum(gt_score * pred_score), torch.sum(pred_score),
        geo_num, *([] if geo_den is None else [geo_den]),
    )
    dice = 1.0 - 2.0 * inter / (n_pos + s_pred + 1e-5)
    geo = geo_num / rest[0] if use_ohem else geo_num / (n_pos + 1e-5)
    total = dice + geo
    return torch.where(n_pos < 1.0, 0.0 * total, total)


def soft_dice_coefficient(gt: torch.Tensor, pred: torch.Tensor, group=None) -> torch.Tensor:
    """Validation metric 2|gt·pred| / (|gt| + |pred|)."""
    inter, s_gt, s_pred = _global_sums(group, torch.sum(gt * pred), torch.sum(gt), torch.sum(pred))
    return 2.0 * inter / (s_gt + s_pred + 1e-5)


def trba_ce_loss(logits: torch.Tensor, targets: torch.Tensor, pad_id: int,
                 group=None) -> torch.Tensor:
    """logits (B, T, V), targets (B, T) int → mean cross-entropy over the
    positions whose target is not PAD."""
    mask = (targets != pad_id).to(logits.dtype)
    ce = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long(), reduction="none"
    ).reshape(targets.shape)
    num, den = _global_sums(group, torch.sum(ce * mask), torch.sum(mask))
    return num / torch.clamp(den, min=1.0)
