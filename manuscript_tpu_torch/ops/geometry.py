"""Host polygon geometry in numpy (counterpart of
``manuscript_tpu/ops/geometry.py``): the float64 Sutherland–Hodgman IoU that
detection F1 scores with and the host LANMS merges with, the vertex
re-ordering of the LANMS merge, batched areas and the point-in-polygon test.
Polygons are (N, 2) arrays of (x, y)."""

from __future__ import annotations

import numpy as np

_CLIP_BUF = 20  # max vertices during Sutherland–Hodgman clip of two quads


def polygon_area(poly: np.ndarray) -> float:
    """Absolute polygon area via the shoelace formula."""
    poly = np.asarray(poly, dtype=np.float64)
    x, y = poly[:, 0], poly[:, 1]
    return float(np.abs(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y)) / 2.0)


def compute_intersection(p1, p2, a, b) -> np.ndarray:
    """Intersection of the infinite lines (p1, p2) and (a, b); ``p1`` for
    parallel lines."""
    p1 = np.asarray(p1, dtype=np.float64)
    p2 = np.asarray(p2, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    d1 = p2 - p1
    d2 = b - a
    denom = d1[0] * d2[1] - d1[1] * d2[0]
    if denom == 0:
        return p1.copy()
    ca = a - p1
    t = (ca[0] * d2[1] - ca[1] * d2[0]) / denom
    return p1 + t * d1


def clip_polygon(subject: np.ndarray, a, b):
    """Clip ``subject`` against the half-plane left of the directed line
    a→b (inside: cross(b − a, p − a) ≥ 0) → (vertices, count)."""
    subject = np.asarray(subject, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    out = np.empty((_CLIP_BUF, 2), dtype=np.float64)
    count = 0
    n = subject.shape[0]
    ab = b - a
    for i in range(n):
        curr = subject[i]
        prev = subject[(i - 1) % n]
        curr_in = ab[0] * (curr[1] - a[1]) - ab[1] * (curr[0] - a[0]) >= 0
        prev_in = ab[0] * (prev[1] - a[1]) - ab[1] * (prev[0] - a[0]) >= 0
        if curr_in:
            if not prev_in:
                out[count] = compute_intersection(prev, curr, a, b)
                count += 1
            out[count] = curr
            count += 1
        elif prev_in:
            out[count] = compute_intersection(prev, curr, a, b)
            count += 1
    return out[:count], count


def polygon_intersection(poly1: np.ndarray, poly2: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman intersection of two convex polygons."""
    current = np.asarray(poly1, dtype=np.float64).copy()
    poly2 = np.asarray(poly2, dtype=np.float64)
    m = poly2.shape[0]
    for i in range(m):
        current, count = clip_polygon(current, poly2[i], poly2[(i + 1) % m])
        if count == 0:
            return np.empty((0, 2), dtype=np.float64)
    return np.ascontiguousarray(current, dtype=np.float64)


def polygon_iou(poly1: np.ndarray, poly2: np.ndarray) -> float:
    """IoU of two convex polygons; 0 for empty or degenerate unions."""
    inter_poly = polygon_intersection(poly1, poly2)
    inter_area = polygon_area(inter_poly) if inter_poly.shape[0] > 2 else 0.0
    union = polygon_area(poly1) + polygon_area(poly2) - inter_area
    if union <= 0:
        return 0.0
    return inter_area / union


def should_merge(poly1: np.ndarray, poly2: np.ndarray, iou_threshold: float) -> bool:
    return polygon_iou(poly1, poly2) > iou_threshold


def normalize_polygon(ref: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Re-index ``poly``'s 4 vertices (cyclic shifts, both orientations) to
    the least total squared distance to ``ref``'s vertex order; forward
    orders come first, so they win ties."""
    ref = np.asarray(ref, dtype=np.float64)
    poly = np.asarray(poly, dtype=np.float64)
    idx = np.arange(4)
    orders = np.stack([(s + idx) % 4 for s in range(4)] + [(s - idx) % 4 for s in range(4)])
    cands = poly[orders]  # (8, 4, 2)
    d = np.sum((cands - ref[None]) ** 2, axis=(1, 2))
    return cands[int(np.argmin(d))].copy()


def polygon_area_batch(polys: np.ndarray) -> np.ndarray:
    """Shoelace areas of a batch of polygons (N, V, 2) → (N,)."""
    polys = np.asarray(polys, dtype=np.float64)
    if polys.size == 0:
        return np.zeros((0,), dtype=np.float64)
    x, y = polys[..., 0], polys[..., 1]
    return 0.5 * np.abs(np.sum(x * np.roll(y, -1, axis=1) - y * np.roll(x, -1, axis=1), axis=1))


def point_in_polygon(points: np.ndarray, poly: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    """Whether each point (N, 2) lies inside or on the convex polygon (V, 2),
    whichever its winding."""
    poly = np.asarray(poly, dtype=np.float64)
    points = np.asarray(points, dtype=np.float64)
    edge = np.roll(poly, -1, axis=0) - poly  # (V, 2)
    rel = points[:, None, :] - poly[None, :, :]  # (N, V, 2)
    cross = edge[None, :, 0] * rel[..., 1] - edge[None, :, 1] * rel[..., 0]
    return np.all(cross >= -eps, axis=1) | np.all(cross <= eps, axis=1)
