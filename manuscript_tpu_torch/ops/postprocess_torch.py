"""Detector post-processing on the device (counterpart of
``manuscript_tpu/ops/postprocess_jax.py``): inverse-shrink expansion, rescale
to the original resolution, removal of boxes contained in a strictly larger
valid box, area-anomaly filter, axis alignment — masked fixed-shape ops over
the (M, 9) LANMS output, or over a chunk's (B, M, 9) with each page on its
own."""

from __future__ import annotations

from typing import Tuple, Union

import torch


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(dim=2, keepdim=True))


def expand_quads(quads: torch.Tensor, expand_w: float, expand_h: float) -> torch.Tensor:
    """Push vertices outward along averaged edge normals; quads (M, 4, 2)."""
    x, y = quads[..., 0], quads[..., 1]
    area = (x * torch.roll(y, -1, 1) - torch.roll(x, -1, 1) * y).sum(dim=1)
    sign = torch.where(area == 0, torch.ones_like(area), torch.sign(area))[:, None, None]

    edge1 = quads - torch.roll(quads, 1, 1)
    edge2 = torch.roll(quads, -1, 1) - quads
    len1, len2 = _norm(edge1), _norm(edge2)
    n1 = sign * torch.stack([edge1[..., 1], -edge1[..., 0]], dim=2) / (len1 + 1e-6)
    n2 = sign * torch.stack([edge2[..., 1], -edge2[..., 0]], dim=2) / (len2 + 1e-6)
    n_avg = n1 + n2
    norm = _norm(n_avg)
    n_avg = torch.where(
        norm > 0, n_avg / torch.where(norm == 0, torch.ones_like(norm), norm),
        torch.zeros_like(n_avg),
    )
    scale_xy = torch.tensor([expand_w, expand_h], dtype=quads.dtype, device=quads.device)
    return quads + scale_xy.reshape(1, 1, 2) * torch.minimum(len1, len2) * n_avg


def _points_in_quads(quads: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """quads (B, M, 4, 2) → inside[b, i, j] = all 4 vertices of quad i lie
    inside (or on) quad j of the same page."""
    a = quads
    edge = torch.roll(quads, -1, 2) - a
    rel = quads[:, :, None, :, None, :] - a[:, None, :, None, :, :]
    cross = (edge[:, None, :, None, :, 0] * rel[..., 1]
             - edge[:, None, :, None, :, 1] * rel[..., 0])
    per_vertex = (cross >= -eps).all(dim=-1) | (cross <= eps).all(dim=-1)
    return per_vertex.all(dim=-1)


def quad_areas(quads: torch.Tensor) -> torch.Tensor:
    x, y = quads[..., 0], quads[..., 1]
    return torch.abs((x * torch.roll(y, -1, -1) - torch.roll(x, -1, -1) * y).sum(dim=-1)) / 2.0


def postprocess_boxes(
    boxes: torch.Tensor,
    count: torch.Tensor,
    expand_w: float,
    expand_h: float,
    scale_x: Union[float, torch.Tensor],
    scale_y: Union[float, torch.Tensor],
    axis_aligned: bool = True,
    remove_anomalies: bool = True,
    anomaly_sigma: float = 5.0,
    anomaly_min_count: int = 30,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """([B,] M, 9) score-descending LANMS rows + count ([B,]) → (boxes
    ([B,] M, 9), valid ([B,] M)). With a page axis ``scale_x``/``scale_y``
    may be (B,) tensors, one scale per page."""
    if boxes.dim() == 2:
        out, valid = postprocess_boxes(
            boxes[None], torch.as_tensor(count).reshape(1), expand_w, expand_h,
            scale_x, scale_y, axis_aligned, remove_anomalies, anomaly_sigma,
            anomaly_min_count,
        )
        return out[0], valid[0]
    b, m = boxes.shape[:2]
    dev = boxes.device
    valid = torch.arange(m, device=dev)[None, :] < torch.as_tensor(count, device=dev).reshape(b, 1)
    scores = boxes[..., 8]

    quads = expand_quads(boxes[..., :8].reshape(b * m, 4, 2), expand_w, expand_h).reshape(b, m, 4, 2)
    scale = torch.stack([
        torch.as_tensor(scale_x, dtype=torch.float32, device=dev).expand(b),
        torch.as_tensor(scale_y, dtype=torch.float32, device=dev).expand(b),
    ], dim=1)
    quads = quads * scale.to(quads.dtype).reshape(b, 1, 1, 2)

    # containment: drop i if a strictly larger valid j contains it
    areas = quad_areas(quads)
    larger = areas[:, None, :] > areas[:, :, None] + 1e-6
    not_self = ~torch.eye(m, dtype=torch.bool, device=dev)
    contained = (_points_in_quads(quads) & larger & not_self & valid[:, None, :]).any(dim=2)
    valid = valid & ~contained

    if remove_anomalies:
        n_valid = valid.sum(dim=1, keepdim=True)
        vf = valid.to(quads.dtype)
        denom = n_valid.clamp_min(1)
        mean = (areas * vf).sum(dim=1, keepdim=True) / denom
        std = torch.sqrt((((areas - mean) ** 2) * vf).sum(dim=1, keepdim=True) / denom)
        keep = areas <= mean + anomaly_sigma * std
        apply = (n_valid > anomaly_min_count) & (std > 0) & (keep & valid).any(dim=1, keepdim=True)
        valid = torch.where(apply, valid & keep, valid)

    if axis_aligned:
        x_min, x_max = quads[..., 0].amin(dim=2), quads[..., 0].amax(dim=2)
        y_min, y_max = quads[..., 1].amin(dim=2), quads[..., 1].amax(dim=2)
        quads = torch.stack(
            [
                torch.stack([x_min, y_min], -1),
                torch.stack([x_max, y_min], -1),
                torch.stack([x_max, y_max], -1),
                torch.stack([x_min, y_max], -1),
            ],
            dim=2,
        )
    return torch.cat([quads.reshape(b, m, 8), scores[..., None]], dim=2), valid
