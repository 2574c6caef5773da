"""Training losses (counterpart of ``manuscript_tpu/train/losses.py``), in
torch ops with no data-dependent host branch.

EAST: dice on the score map plus per-pixel L1 summed over the 8 geometry
channels, masked by the ground-truth score map; optionally the focal weight
(1 − e^{−L})^γ, and OHEM as the mean of each sample's top-k pixels with a
static k; a batch with no positive pixel gives a zero loss whose gradient is
still defined. TRBA: token cross-entropy averaged over the non-PAD positions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dice_loss(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """1 − 2·|gt∩pred| / (|gt| + |pred|), global over the batch."""
    inter = torch.sum(gt * pred)
    union = torch.sum(gt) + torch.sum(pred) + 1e-5
    return 1.0 - 2.0 * inter / union


def east_loss(
    gt_score: torch.Tensor,  # (B, H, W) or (B, H, W, 1)
    pred_score: torch.Tensor,
    gt_geo: torch.Tensor,  # (B, H, W, 8)
    pred_geo: torch.Tensor,
    use_ohem: bool = False,
    ohem_ratio: float = 0.5,
    use_focal_geo: bool = False,
    focal_gamma: float = 2.0,
) -> torch.Tensor:
    if gt_score.dim() == 4:
        gt_score = gt_score[..., 0]
    if pred_score.dim() == 4:
        pred_score = pred_score[..., 0]
    n_pos = torch.sum(gt_score)
    dice = dice_loss(gt_score, pred_score)

    geo_map = torch.sum(torch.abs(gt_geo - pred_geo), dim=-1)  # (B, H, W)
    if use_focal_geo:
        geo_map = geo_map * (1.0 - torch.exp(-geo_map)) ** focal_gamma
    geo_map = geo_map * gt_score
    if use_ohem:
        flat = geo_map.reshape(geo_map.shape[0], -1)
        k = max(int(ohem_ratio * flat.shape[1]), 1)
        geo = torch.mean(torch.mean(torch.topk(flat, k, dim=1).values, dim=1))
    else:
        geo = torch.sum(geo_map) / (n_pos + 1e-5)
    total = dice + geo
    return torch.where(n_pos < 1.0, 0.0 * total, total)


def soft_dice_coefficient(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Validation metric 2|gt·pred| / (|gt| + |pred|)."""
    inter = torch.sum(gt * pred)
    union = torch.sum(gt) + torch.sum(pred) + 1e-5
    return 2.0 * inter / union


def trba_ce_loss(logits: torch.Tensor, targets: torch.Tensor, pad_id: int) -> torch.Tensor:
    """logits (B, T, V), targets (B, T) int → mean cross-entropy over the
    positions whose target is not PAD."""
    mask = (targets != pad_id).to(logits.dtype)
    ce = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long(), reduction="none"
    ).reshape(targets.shape)
    return torch.sum(ce * mask) / torch.clamp(torch.sum(mask), min=1.0)
