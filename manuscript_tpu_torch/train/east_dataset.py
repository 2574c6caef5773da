"""EAST training data (counterpart of ``manuscript_tpu/train/east_dataset.py``):
COCO JSON → (image, score map, geometry map), in numpy alone.

Each segmentation polygon becomes its minimum-area rectangle with the
vertices ordered TL, TR, BR, BL; the 0.3-shrunk quad is rasterized into a
quarter-resolution score map, and the geometry channels 2i/2i+1 hold the
shrunk vertex offsets (vx − col, vy − row) in map pixels. Images without a
single annotation of at least 4 points are dropped with a warning.

Three OpenCV routines of the JAX package are rewritten here:

* ``min_area_quad``: cv2 ``minAreaRect`` + ``boxPoints`` as cv2's rotating
  calipers over the convex hull, in its float32 steps;
* ``fill_poly``: cv2 ``fillPoly`` (8-connected, no sub-pixel shift) as its
  own algorithm — each edge drawn with the 8-connected line, then the
  scanline fill with 16-bit fixed-point edge walks (the rounding read off
  cv2 5.0: x + 1/2, a floored slope, spans [left, right) in fixed point).
  It sets the same pixels as cv2 for polygons inside the map. An edge that
  leaves the map is clipped first with cv2's ``clipLine``, and its slope
  and start come from the clipped ends, as cv2 takes them. Around the
  map's border a few pixels still differ from cv2 on about 3 % of random
  rotated quads (tests/test_torch_visualize.py): cv2 5.0's treatment of an
  edge wholly outside the map is not reproduced;
* ``rgb_to_hsv_u8``/``hsv_to_rgb_u8``: cv2's 8-bit RGB ⇄ HSV (hue in
  [0, 180)) for the hue rotation of ``color_jitter``: the forward
  conversion with cv2's integer tables, the inverse in float32.

The read and resize of a page go through ``ops.image.read_image`` and the
port's byte-equal INTER_LINEAR (``resize_u8``). ``batch_iterator`` is a
threaded prefetching loader.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import warnings
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..ops.boxes import expand_boxes
from ..ops.image import read_image, resize_u8, to_rgb_u8


def order_vertices_clockwise(poly: np.ndarray) -> np.ndarray:
    """Order 4 points TL, TR, BR, BL by coordinate sums and differences."""
    poly = np.asarray(poly, dtype=np.float32).reshape(-1, 2)
    s = poly.sum(axis=1)
    d = np.diff(poly, axis=1).ravel()
    return np.array(
        [poly[np.argmin(s)], poly[np.argmin(d)], poly[np.argmax(s)], poly[np.argmax(d)]],
        dtype=np.float32,
    )


def shrink_quad(quad: np.ndarray, ratio: float = 0.3) -> np.ndarray:
    """Move each vertex inward by ratio·min(adjacent edge lengths) along the
    averaged inward normal: the inverse of ``ops.boxes.expand_boxes``."""
    row = np.concatenate([np.asarray(quad, np.float32).reshape(8), [1.0]])[None]
    return expand_boxes(row, expand_w=-ratio, expand_h=-ratio)[0, :8].reshape(4, 2)


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Counter-clockwise convex hull (monotone chain) of (N, 2) points."""
    pts = np.unique(np.asarray(points, np.float64).reshape(-1, 2), axis=0)
    if len(pts) < 3:
        return pts

    def half(seq):
        out: List[np.ndarray] = []
        for p in seq:
            while len(out) >= 2:
                (ax, ay), (bx, by) = out[-2], out[-1]
                if (bx - ax) * (p[1] - ay) - (by - ay) * (p[0] - ax) > 0:
                    break
                out.pop()
            out.append(p)
        return out

    lower, upper = half(pts), half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def _min_area_rect(hull: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv2's rotating calipers over a hull of n > 2 points, in its float32
    arithmetic → (corner, side 1, side 2) of the minimum-area rectangle."""
    f32 = np.float32
    pts = hull.astype(f32)
    n = len(pts)
    vect = np.roll(pts, -1, axis=0) - pts
    inv_len = (1.0 / np.sqrt(vect.astype(np.float64) ** 2 @ np.ones(2))).astype(f32)
    left = right = top = bottom = 0
    for i in range(n):  # first extreme points, scanning from the start
        x, y = pts[i]
        if x < pts[left, 0]:
            left = i
        if x > pts[right, 0]:
            right = i
        if y > pts[top, 1]:
            top = i
        if y < pts[bottom, 1]:
            bottom = i
    orientation = f32(1.0)
    for i in range(n):
        (ax, ay), (bx, by) = vect[i - 1].astype(np.float64), vect[i].astype(np.float64)
        if ax * by - ay * bx != 0:
            orientation = f32(1.0 if ax * by - ay * bx > 0 else -1.0)
            break
    base_a, base_b = orientation, f32(0.0)
    seq = [bottom, right, top, left]
    best = None
    for _ in range(n):
        v = [vect[seq[k]] for k in range(4)]
        dp = [base_a * v[0][0] + base_b * v[0][1], -base_b * v[1][0] + base_a * v[1][1],
              -base_a * v[2][0] - base_b * v[2][1], base_b * v[3][0] - base_a * v[3][1]]
        cos = [dp[k] * inv_len[seq[k]] for k in range(4)]
        main = max(range(4), key=lambda k: (cos[k], -k))  # the first of equal cosines
        lead_x, lead_y = vect[seq[main]] * inv_len[seq[main]]
        base_a, base_b = ((lead_x, lead_y), (lead_y, -lead_x), (-lead_x, -lead_y), (-lead_y, lead_x))[main]
        seq[main] = (seq[main] + 1) % n
        dx, dy = pts[seq[1]] - pts[seq[3]]
        width = dx * base_a + dy * base_b
        dx, dy = pts[seq[2]] - pts[seq[0]]
        height = -dx * base_b + dy * base_a
        area = width * height
        if best is None or area <= best[0]:
            best = (area, seq[3], base_a, width, base_b, height, seq[0])
    _, li, a1, width, b1, height, bi = best
    a2, b2 = -b1, a1
    c1 = a1 * pts[li, 0] + pts[li, 1] * b1
    c2 = a2 * pts[bi, 0] + pts[bi, 1] * b2
    idet = f32(1.0) / (a1 * b2 - a2 * b1)
    corner = np.array([(c1 * b2 - c2 * b1) * idet, (a1 * c2 - a2 * c1) * idet], f32)
    return corner, np.array([a1 * width, b1 * width], f32), np.array([a2 * height, b2 * height], f32)


def min_area_rect(points: np.ndarray) -> Tuple[np.ndarray, Tuple[np.float32, np.float32], np.ndarray]:
    """cv2's ``minAreaRect(points)`` rectangle → (centre (2,), (width,
    height), side 1 (2,)), float32, where cv2 4 takes the angle as the
    direction of side 1: the hull starts at its rightmost point, as cv2's
    does, and the calipers and the rectangle are computed in cv2's float32
    steps, so near-ties between rectangles resolve as in cv2. A hull of two
    points gives cv2's segment box, of one point its point."""
    f32 = np.float32
    hull = convex_hull(points)
    if len(hull) == 1:
        return hull[0].astype(f32), (f32(0.0), f32(0.0)), np.array([1.0, 0.0], f32)
    if len(hull) == 2:
        a, b = hull.astype(f32)
        side = b - a
        return (a + b) * f32(0.5), (f32(np.sqrt(float(side @ side.astype(np.float64)))), f32(0.0)), side
    hull = np.roll(hull, -int(np.argmax(hull[:, 0])), axis=0)
    corner, side1, side2 = _min_area_rect(hull)
    center = corner + (side1 + side2) * f32(0.5)
    size = (f32(np.sqrt(float(side1 @ side1.astype(np.float64)))),
            f32(np.sqrt(float(side2 @ side2.astype(np.float64)))))
    return center, size, side1


def min_area_quad(points: np.ndarray) -> np.ndarray:
    """cv2 ``boxPoints(minAreaRect(points))`` ordered TL, TR, BR, BL, in
    cv2's float32 steps (``min_area_rect``)."""
    hull = convex_hull(points)
    if len(hull) < 3:
        lo, hi = hull[0].astype(np.float32), hull[-1].astype(np.float32)
        return order_vertices_clockwise(np.array([lo, hi, hi, lo]))
    f32 = np.float32
    center, size, side1 = min_area_rect(hull)
    angle = f32(float(f32(np.arctan2(float(side1[1]), float(side1[0])))) * 180 / np.pi)
    rad = float(angle) * np.pi / 180.0
    b, a = f32(np.cos(rad)) * f32(0.5), f32(np.sin(rad)) * f32(0.5)
    p0 = np.array([center[0] - a * size[1] - b * size[0], center[1] + b * size[1] - a * size[0]], f32)
    p1 = np.array([center[0] + a * size[1] - b * size[0], center[1] - b * size[1] - a * size[0]], f32)
    box = np.stack([p0, p1, 2 * center - p0, 2 * center - p1])
    return order_vertices_clockwise(box)


_XY_SHIFT = 16


def _line_pixels(x0: int, y0: int, x1: int, y1: int) -> List[Tuple[int, int]]:
    """The pixels of cv2's 8-connected line from (x0, y0) to (x1, y1), drawn
    left to right with its Bresenham error term."""
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    major_y = dy > dx
    if major_y:
        dx, dy = dy, dx
    err, x, y, out = dx - 2 * dy, x0, y0, []
    for _ in range(dx + 1):
        out.append((x, y))
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if major_y:
            y += sy
            x += 1 if minor else 0
        else:
            x += 1
            y += sy if minor else 0
    return out


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2's ``clipLine`` of a segment to a w × h image (its Cohen–Sutherland
    steps, the intersections truncated toward zero) → (inside, x1, y1, x2,
    y2)."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, x1, y1, x2, y2


class _Edge:
    __slots__ = ("y0", "y1", "x", "dx")

    def __init__(self, y0: int, y1: int, x: int, dx: int):
        self.y0, self.y1, self.x, self.dx = y0, y1, x, dx


def fill_poly(mask: np.ndarray, pts: np.ndarray, value: int = 1) -> np.ndarray:
    """cv2.fillPoly(mask, [pts], value) for one int polygon, in place."""
    h, w = mask.shape[:2]
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    half = 1 << (_XY_SHIFT - 1)
    edges: List[_Edge] = []
    for i in range(len(pts)):
        (x0, y0), (x1, y1) = pts[i - 1], pts[i]
        # an edge that leaves the image is clipped first: its line is drawn
        # between the clipped ends, and its slope and start are taken from
        # them (from the unclipped ends, without the half, when the clipped
        # segment is flat)
        inside = 0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h
        ok, cx0, cy0, cx1, cy1 = (True, x0, y0, x1, y1) if inside else _clip_line(w, h, x0, y0, x1, y1)
        if ok:
            for px, py in _line_pixels(cx0, cy0, cx1, cy1):
                mask[py, px] = value
        if y0 == y1:
            continue
        # pixel centres: x + 1/2 in 16-bit fixed point, the slope floored
        if cy0 != cy1:
            fx0, fx1 = (cx0 << _XY_SHIFT) + half, (cx1 << _XY_SHIFT) + half
        else:
            fx0, fx1 = x0 << _XY_SHIFT, x1 << _XY_SHIFT
            cy0, cy1 = y0, y1
        dx = (fx1 - fx0) // (cy1 - cy0)
        if y0 < y1:
            edges.append(_Edge(y0, y1, fx0 + (y0 - cy0) * dx, dx))
        else:
            edges.append(_Edge(y1, y0, fx1 + (y1 - cy1) * dx, dx))
    if len(edges) < 2:
        return mask
    xs = [e.x for e in edges] + [e.x + (e.y1 - e.y0) * e.dx for e in edges]
    y_min, y_max = min(e.y0 for e in edges), max(e.y1 for e in edges)
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << _XY_SHIFT):
        return mask
    edges.sort(key=lambda e: (e.y0, e.x, e.dx))
    active: List[_Edge] = []
    nxt = 0
    for y in range(edges[0].y0, min(y_max, h)):
        active = [e for e in active if e.y1 != y]
        # insert the edges that start here, each before the first active edge
        # at or right of it, walking on from the previous insertion (cv2's
        # linked-list walk)
        pos = 0
        while nxt < len(edges) and edges[nxt].y0 == y:
            e = edges[nxt]
            while pos < len(active) and active[pos].x < e.x:
                pos += 1
            active.insert(pos, e)
            pos += 1
            nxt += 1
        for left, right in zip(active[0::2], active[1::2]):
            if y >= 0:
                a, b = sorted((left.x, right.x))
                x1, x2 = a >> _XY_SHIFT, (b - 1) >> _XY_SHIFT  # [left, right)
                if x1 < w and x2 >= 0:
                    mask[y, max(x1, 0) : min(x2, w - 1) + 1] = value
            left.x += left.dx
            right.x += right.dx
        active.sort(key=lambda e: e.x)
    return mask


def rasterize_quad_maps(
    quads: Sequence[np.ndarray],
    target_size: int,
    score_geo_scale: float = 0.25,
) -> Tuple[np.ndarray, np.ndarray]:
    """(score (h, w), geometry (h, w, 8)) float32 maps from input-scale quads."""
    out_h = out_w = int(target_size * score_geo_scale)
    score = np.zeros((out_h, out_w), dtype=np.float32)
    geo = np.zeros((out_h, out_w, 8), dtype=np.float32)
    for quad in quads:
        coords = shrink_quad(order_vertices_clockwise(quad), 0.3) * score_geo_scale
        mask = fill_poly(np.zeros((out_h, out_w), np.uint8), np.round(coords).astype(np.int32))
        rr, cc = np.nonzero(mask)
        if len(rr) == 0:
            continue
        score[rr, cc] = 1.0
        for i, (vx, vy) in enumerate(coords):
            geo[rr, cc, 2 * i] = vx - cc
            geo[rr, cc, 2 * i + 1] = vy - rr
    return score, geo


_HSV_SHIFT = 12
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / np.arange(1, 256))]).astype(np.int64)
_HDIV180 = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256)))]).astype(np.int64)
_HSV_BLOCK = 32
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def rgb_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_RGB2HSV) for uint8: H in [0, 180), S and V in
    [0, 255], by cv2's 12-bit integer tables."""
    rgb = img.astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v, vmin = rgb.max(axis=-1), rgb.min(axis=-1)
    diff = v - vmin
    rnd = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + rnd) >> _HSV_SHIFT
    hue = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    hue = (hue * _HDIV180[diff] + rnd) >> _HSV_SHIFT
    hue = np.where(hue < 0, hue + 180, hue)
    return np.stack([hue, s, v], axis=-1).clip(0, 255).astype(np.uint8)


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, COLOR_HSV2RGB) for uint8 (H in [0, 180)), in float32
    as cv2 computes it, for an (H, W, 3) image."""
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    h = np.fmod(h, f32(6.0))
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(f32)
    bad = (sector < 0) | (sector >= 6)
    sector, h = np.where(bad, 0, sector), np.where(bad, f32(0), h)
    one = f32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * h), v * (one - s * (one - h))], axis=-1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], axis=-1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    # cv2 converts each row in blocks of 4 SIMD vectors of pixels, 32 with
    # AVX2, and truncates there; the row's tail goes the scalar way, rounded
    scaled = bgr * f32(255.0)
    body = (scaled.shape[-2] // _HSV_BLOCK) * _HSV_BLOCK
    out = np.concatenate([np.trunc(scaled[..., :body, :]), np.rint(scaled[..., body:, :])], axis=-2)
    return np.clip(out, 0, 255).astype(np.uint8)[..., ::-1].copy()


def color_jitter(
    img: np.ndarray,
    rng: np.random.Generator,
    brightness: float = 0.5,
    contrast: float = 0.5,
    saturation: float = 0.5,
    hue: float = 0.25,
) -> np.ndarray:
    """torchvision-style ColorJitter on uint8 RGB, with the JAX package's
    draws in its order."""
    out = img.astype(np.float32)
    if brightness > 0:
        out = out * rng.uniform(1 - brightness, 1 + brightness)
    if contrast > 0:
        mean = out.mean()
        out = (out - mean) * rng.uniform(1 - contrast, 1 + contrast) + mean
    if saturation > 0:
        gray = out.mean(axis=2, keepdims=True)
        out = gray + (out - gray) * rng.uniform(1 - saturation, 1 + saturation)
    if hue > 0:
        hsv = rgb_to_hsv_u8(np.clip(out, 0, 255).astype(np.uint8)).astype(np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(rng.uniform(-hue, hue) * 180)) % 180
        out = hsv_to_rgb_u8(hsv.astype(np.uint8)).astype(np.float32)
    return np.clip(out, 0, 255).astype(np.uint8)


class EASTDataset:
    """COCO-annotated pages → (image u8 (S, S, 3), score (h, w), geometry
    (h, w, 8), quads) training items; the label maps are cached up to
    ``cache_maps_mb``."""

    def __init__(
        self,
        images_folder: Union[str, Path],
        coco_annotation_file: Union[str, Path],
        target_size: int = 512,
        score_geo_scale: float = 0.25,
        augment: bool = True,
        dataset_name: Optional[str] = None,
        seed: int = 0,
        cache_maps_mb: float = 2048.0,
    ):
        self.images_folder = str(images_folder)
        self.target_size = target_size
        self.score_geo_scale = score_geo_scale
        self.augment = augment
        self.dataset_name = dataset_name or Path(images_folder).stem
        self.rng = np.random.default_rng(seed)

        with open(coco_annotation_file, "r", encoding="utf-8") as f:
            data = json.load(f)
        self.images_info = {img["id"]: img for img in data["images"]}
        self.image_ids = list(self.images_info.keys())
        self.annots: Dict = {}
        for ann in data["annotations"]:
            self.annots.setdefault(ann["image_id"], []).append(ann)
        self._drop_invalid()
        self._map_cache: Dict[int, tuple] = {}
        self._map_cache_budget = int(cache_maps_mb * 1e6)
        self._map_cache_bytes = 0

    def _drop_invalid(self) -> None:
        def valid(ann) -> bool:
            seg = ann.get("segmentation")
            if not seg:
                return False
            flat = seg[0] if isinstance(seg[0], list) else seg
            return np.asarray(flat, dtype=np.float32).reshape(-1, 2).shape[0] >= 4

        bad = [i for i in self.image_ids if not any(valid(a) for a in self.annots.get(i, []))]
        for img_id in bad:
            self.image_ids.remove(img_id)
            self.annots.pop(img_id, None)
        if bad:
            warnings.warn(f"EASTDataset: dropped {len(bad)} images without valid quads", UserWarning)

    def __len__(self) -> int:
        return len(self.image_ids)

    def quads_for(self, idx: int) -> List[np.ndarray]:
        """Input-scale ground-truth quads of sample ``idx``."""
        image_id = self.image_ids[idx]
        info = self.images_info[image_id]
        sx, sy = self.target_size / info["width"], self.target_size / info["height"]
        quads = []
        for ann in self.annots.get(image_id, []):
            seg = ann.get("segmentation")
            if not seg:
                continue
            for part in (seg if isinstance(seg[0], list) else [seg]):
                pts = np.asarray(part, dtype=np.float32).reshape(-1, 2)
                if pts.size == 0:
                    continue
                quad = min_area_quad(pts)
                quad[:, 0] *= sx
                quad[:, 1] *= sy
                quads.append(quad)
        return quads

    def __getitem__(self, idx: int):
        info = self.images_info[self.image_ids[idx]]
        path = os.path.join(self.images_folder, info["file_name"])
        if not os.path.exists(path):
            raise FileNotFoundError(f"Image not found: {path}")
        img = resize_u8(to_rgb_u8(read_image(path)), self.target_size, self.target_size)
        if self.augment:
            img = color_jitter(img, self.rng)
        # the label maps depend on idx alone (the augmentation is
        # photometric): rasterized once, then cached within the budget
        cached = self._map_cache.get(idx)
        if cached is None:
            quads = self.quads_for(idx)
            score, geo = rasterize_quad_maps(quads, self.target_size, self.score_geo_scale)
            cached = (score, geo, quads)
            size = score.nbytes + geo.nbytes
            if self._map_cache_bytes + size <= self._map_cache_budget:
                self._map_cache[idx] = cached
                self._map_cache_bytes += size
        score, geo, quads = cached
        return img, score, geo, quads


class ConcatDataset:
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        ds_idx = int(np.searchsorted(self._offsets[1:], idx, side="right"))
        return self.datasets[ds_idx][idx - self._offsets[ds_idx]]


def batch_iterator(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = False,
    num_threads: int = 4,
    include_quads: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """Batches {"image" (B, S, S, 3) u8, "score" (B, h, w), "geo" (B, h, w,
    8)} (and "quads" with ``include_quads``), built by a prefetching thread."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    chunks = [order[i : i + batch_size] for i in range(0, len(order), batch_size)]
    if drop_last:
        chunks = [c for c in chunks if len(c) == batch_size]

    q: "queue.Queue" = queue.Queue(maxsize=max(2, num_threads))
    sentinel = object()

    def worker():
        try:
            for chunk in chunks:
                items = [dataset[int(i)] for i in chunk]
                batch = {
                    "image": np.stack([it[0] for it in items]),
                    "score": np.stack([it[1] for it in items]),
                    "geo": np.stack([it[2] for it in items]),
                }
                if include_quads:
                    batch["quads"] = [it[3] for it in items]
                q.put(batch)
        except Exception as e:  # re-raised in the consumer
            q.put(e)
        q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            break
        if isinstance(item, Exception):
            raise item
        yield item
