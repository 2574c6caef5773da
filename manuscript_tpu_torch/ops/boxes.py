"""Host box operations of the detector's post-processing, in float64 numpy
(the port's copy of ``manuscript_tpu/ops/boxes.py``): inverse-shrink
expansion, rescale to the original resolution, containment and area-anomaly
filters, axis alignment. All take (n, 9) arrays of [x0..y3, score] rows.
``quad_to_rbox`` gives a quad's rotated box as cv2's ``minAreaRect`` does."""

from __future__ import annotations

import numpy as np

from .geometry import polygon_area_batch


def expand_boxes(quads: np.ndarray, expand_w: float = 0.0, expand_h: float = 0.0) -> np.ndarray:
    """Push each vertex outward along its averaged edge normal by
    min(adjacent edge lengths) × the expand ratio of its axis: the inverse of
    the label shrink the detector was trained with."""
    if len(quads) == 0 or (expand_w == 0 and expand_h == 0):
        return quads
    coords = quads[:, :8].reshape(-1, 4, 2).astype(np.float64)
    scores = quads[:, 8:9]

    x, y = coords[:, :, 0], coords[:, :, 1]
    area = np.sum(x * np.roll(y, -1, axis=1) - np.roll(x, -1, axis=1) * y, axis=1)
    sign = np.sign(area).reshape(-1, 1, 1)
    sign[sign == 0] = 1

    edge1 = coords - np.roll(coords, 1, axis=1)
    edge2 = np.roll(coords, -1, axis=1) - coords
    len1 = np.linalg.norm(edge1, axis=2, keepdims=True)
    len2 = np.linalg.norm(edge2, axis=2, keepdims=True)
    n1 = sign * np.stack([edge1[..., 1], -edge1[..., 0]], axis=2) / (len1 + 1e-6)
    n2 = sign * np.stack([edge2[..., 1], -edge2[..., 0]], axis=2) / (len2 + 1e-6)
    n_avg = n1 + n2
    norm = np.linalg.norm(n_avg, axis=2, keepdims=True)
    n_avg = np.divide(n_avg, norm, out=np.zeros_like(n_avg), where=norm > 0)

    scale_xy = np.array([expand_w, expand_h], dtype=np.float64).reshape(1, 1, 2)
    new_coords = coords + scale_xy * np.minimum(len1, len2) * n_avg
    return np.hstack([new_coords.reshape(-1, 8), scores]).astype(np.float32)


def scale_boxes(boxes: np.ndarray, from_size: int, orig_h: int, orig_w: int) -> np.ndarray:
    """Coordinates on the square from_size² canvas → the original page."""
    if len(boxes) == 0:
        return boxes
    scaled = boxes.copy()
    scaled[:, 0:8:2] *= orig_w / from_size
    scaled[:, 1:8:2] *= orig_h / from_size
    return scaled


def to_axis_aligned(quads: np.ndarray) -> np.ndarray:
    """Each quad → its bounding rectangle (x_min, y_min) → (x_max, y_min) →
    (x_max, y_max) → (x_min, y_max)."""
    if len(quads) == 0:
        return quads
    aligned = quads.copy()
    coords = aligned[:, :8].reshape(-1, 4, 2)
    x_min, x_max = coords[:, :, 0].min(axis=1), coords[:, :, 0].max(axis=1)
    y_min, y_max = coords[:, :, 1].min(axis=1), coords[:, :, 1].max(axis=1)
    aligned[:, :8] = np.stack([x_min, y_min, x_max, y_min, x_max, y_max, x_min, y_max], axis=1)
    return aligned


def remove_fully_contained(quads: np.ndarray) -> np.ndarray:
    """Drop every quad whose 4 vertices lie inside a strictly larger quad
    (area larger by more than 1e-6). Only the smaller quad is ever removed,
    so the rule does not depend on the order of the rows: one pairwise test,
    exact only on the pairs whose bounding boxes nest."""
    n = len(quads)
    if n <= 1:
        return quads
    coords = quads[:, :8].reshape(-1, 4, 2).astype(np.float64)
    areas = polygon_area_batch(coords)

    x_min, x_max = coords[..., 0].min(1), coords[..., 0].max(1)
    y_min, y_max = coords[..., 1].min(1), coords[..., 1].max(1)
    slack = 1e-6
    pre = (
        (x_min[:, None] >= x_min[None, :] - slack)
        & (x_max[:, None] <= x_max[None, :] + slack)
        & (y_min[:, None] >= y_min[None, :] - slack)
        & (y_max[:, None] <= y_max[None, :] + slack)
        & (areas[None, :] > areas[:, None] + 1e-6)
    )
    np.fill_diagonal(pre, False)
    ii, jj = np.nonzero(pre)
    if len(ii) == 0:
        return quads

    pts, poly = coords[ii], coords[jj]  # (P, 4, 2): maybe-inner quads, containers
    edge = np.roll(poly, -1, axis=1) - poly
    rel = pts[:, :, None, :] - poly[:, None, :, :]  # (P, 4 vertices, 4 edges, 2)
    cross = edge[:, None, :, 0] * rel[..., 1] - edge[:, None, :, 1] * rel[..., 0]
    eps = 1e-9
    per_vertex = np.all(cross >= -eps, axis=-1) | np.all(cross <= eps, axis=-1)
    contained = np.zeros(n, dtype=bool)
    np.logical_or.at(contained, ii, np.all(per_vertex, axis=-1))
    return quads[~contained]


def remove_area_anomalies(
    quads: np.ndarray, sigma_threshold: float = 5.0, min_box_count: int = 30
) -> np.ndarray:
    """Drop quads whose area exceeds mean + sigma_threshold·std; inert on a
    page with at most ``min_box_count`` boxes."""
    if len(quads) == 0 or len(quads) <= min_box_count:
        return quads
    areas = polygon_area_batch(quads[:, :8].reshape(-1, 4, 2)).astype(np.float32)
    mean, std = float(np.mean(areas)), float(np.std(areas))
    if std == 0.0:
        return quads
    keep = areas <= mean + sigma_threshold * std
    if not np.any(keep):
        return quads
    return quads[keep]


def quad_bbox_int(polygon: np.ndarray) -> tuple:
    """Integer axis-aligned bbox (x_min, y_min, x_max, y_max) of a polygon."""
    poly = np.asarray(polygon, dtype=np.int32)
    x_min, y_min = np.min(poly, axis=0)
    x_max, y_max = np.max(poly, axis=0)
    return (int(x_min), int(y_min), int(x_max), int(y_max))


def quad_to_rbox(quad: np.ndarray) -> np.ndarray:
    """Quad (8 or 9 floats) → rotated box [cx, cy, w, h, angle (degrees)],
    float32, as cv2 5's ``minAreaRect`` gives it: the rectangle of
    ``train/east_dataset.min_area_rect``, its angle the direction of its
    first side, turned by 90° (the sides swapped each time) into [−90, 0)."""
    from ..train.east_dataset import min_area_rect

    pts = np.asarray(quad, dtype=np.float32).reshape(-1)[:8].reshape(4, 2)
    (cx, cy), (w, h), side = min_area_rect(pts)
    angle = float(np.degrees(np.arctan2(float(side[1]), float(side[0]))))
    while angle >= 0.0 or angle < -90.0:
        w, h, angle = h, w, angle - 90.0 if angle >= 0.0 else angle + 90.0
    return np.array([cx, cy, w, h, angle], dtype=np.float32)
