"""Drawing of detection results (counterpart of
``manuscript_tpu/utils/visualize.py``): ``draw_quads``, ``visualize_page``
and the training collage ``create_collage``, without OpenCV.

* ``shade_quads`` is the numpy core, which needs no PIL: the page darkened
  by ``dark_alpha`` outside the words, through a softly blurred mask. The
  mask is drawn with ``train/east_dataset.fill_poly`` (cv2's ``fillPoly``)
  and blurred by ``gaussian_blur``, which computes cv2's ``GaussianBlur`` of
  a float32 image with σ = 0 (σ from the kernel size, as cv2 takes it;
  cv2's fixed kernels for sizes up to 7; ``BORDER_REFLECT_101``; its order
  of float32 sums, so that the blurred mask equals cv2's on an x86 build
  with FMA).
* The outlines, the reading-order numbers and the returned
  ``PIL.Image.Image`` use PIL, imported inside the functions that draw; a
  missing PIL raises ImportError there.
* ``_colormap`` renders a map with cv2's ``COLORMAP_JET`` table (RGB order),
  and the collage resizes its cells with ``ops/image.resize_u8`` (cv2's
  INTER_LINEAR).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops.image import resize_u8

# cv2.getGaussianKernel's fixed kernels for σ ≤ 0 and sizes up to 7
_SMALL_GAUSSIAN = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def gaussian_kernel(k: int) -> np.ndarray:
    """cv2.getGaussianKernel(k, 0) as float32: σ = 0.3·((k − 1)·0.5 − 1) + 0.8,
    weights normalized in float64."""
    if k in _SMALL_GAUSSIAN:
        return np.asarray(_SMALL_GAUSSIAN[k], np.float32)
    sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8
    x = np.arange(k, dtype=np.float64) - (k - 1) * 0.5
    w = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (w / w.sum()).astype(np.float32)


def _taps(img: np.ndarray, r: int, axis: int):
    """``tap(off)``: the image shifted by ``off`` along ``axis``, with
    BORDER_REFLECT_101 beyond the edges."""
    pad = [(0, 0)] * img.ndim
    pad[axis] = (r, r)
    src = np.pad(img, pad, mode="reflect")
    n = img.shape[axis]
    return lambda off: np.take(src, np.arange(r + off, r + off + n), axis=axis)


def gaussian_blur(img: np.ndarray, k: int) -> np.ndarray:
    """cv2.GaussianBlur(img, (k, k), 0) of a 2-D float32 image (k odd), in
    cv2's float32 steps: the row pass adds the taps left to right; the
    column pass starts at the centre tap and adds each symmetric pair with a
    fused multiply-add (emulated in float64, exact for float32 operands)."""
    w = gaussian_kernel(k)
    r = k // 2
    tap = _taps(np.asarray(img, np.float32), r, 1)
    rows = w[0] * tap(-r)
    for j in range(1, k):
        rows = rows + w[j] * tap(j - r)
    tap = _taps(rows.astype(np.float32), r, 0)
    out = w[r] * tap(0)
    for j in range(1, r + 1):
        pair = (tap(j) + tap(-j)).astype(np.float32)
        out = (np.float64(w[r + j]) * pair + out.astype(np.float64)).astype(np.float32)
    return out


def _quad_points(q) -> np.ndarray:
    return np.asarray(q).reshape(-1)[:8].reshape(4, 2)


def shade_quads(image: np.ndarray, quads, dark_alpha: float = 0.5, blur_ksize: int = 11) -> np.ndarray:
    """The page (H, W, 3) uint8 darkened by ``dark_alpha`` outside the quads,
    blended through their blurred mask → uint8. An even ``blur_ksize`` blurs
    with ``blur_ksize + 1``, as the JAX package passes it to cv2."""
    from ..train.east_dataset import fill_poly

    img = np.asarray(image)
    h, w = img.shape[:2]
    dark_bg = (img.astype(np.float32) * (1 - dark_alpha)).astype(np.uint8)
    mask = np.zeros((h, w), dtype=np.float32)
    for q in quads:
        fill_poly(mask, _quad_points(q).astype(np.int32), 1.0)
    k = blur_ksize if blur_ksize % 2 == 1 else blur_ksize + 1
    mask = np.clip(gaussian_blur(mask, k), 0.0, 1.0)[:, :, None]
    out = img.astype(np.float32) * mask + dark_bg.astype(np.float32) * (1 - mask)
    return np.clip(out, 0, 255).astype(np.uint8)


def draw_quads(
    image: np.ndarray,
    quads,
    color: tuple = (0, 0, 0),
    thickness: int = 1,
    dark_alpha: float = 0.5,
    blur_ksize: int = 11,
):
    """Quad outlines over the softly darkened page → PIL image."""
    from PIL import Image, ImageDraw

    img = np.asarray(image).copy()
    if quads is None or len(quads) == 0:
        return Image.fromarray(img)
    quads = np.asarray(quads)
    pil = Image.fromarray(shade_quads(img, quads, dark_alpha, blur_ksize))
    draw = ImageDraw.Draw(pil)
    for q in quads:
        pts = [tuple(map(float, p)) for p in _quad_points(q)]
        draw.line(pts + [pts[0]], fill=tuple(color), width=max(1, int(thickness)))
    return pil


def _jet_table() -> np.ndarray:
    """cv2's COLORMAP_JET as a (256, 3) uint8 RGB table: three clipped ramps
    of slope 4, and blue's entry 159, which cv2's float interpolation rounds
    down to 1 where the ramp gives 2."""
    i = np.arange(256)
    r = np.clip(np.minimum(4 * i - 382, 1148 - 4 * i), 0, 255)
    g = np.clip(np.minimum(4 * i - 128, 892 - 4 * i), 0, 255)
    b = np.clip(np.minimum(4 * i + 128, 638 - 4 * i), 0, 255)
    b[159] = 1
    return np.stack([r, g, b], axis=1).astype(np.uint8)


JET_RGB = _jet_table()


def _colormap(channel: np.ndarray) -> np.ndarray:
    """Min-max normalize a 2-D map and render it with JET → (H, W, 3) RGB."""
    lo, hi = float(channel.min()), float(channel.max())
    norm = (channel - lo) / (hi - lo) if hi > lo else np.zeros_like(channel)
    return JET_RGB[(norm * 255).astype(np.uint8)]


def create_collage(
    image_u8: np.ndarray,
    gt_score: np.ndarray,
    gt_geo: np.ndarray,
    gt_quads=None,
    pred_score: Optional[np.ndarray] = None,
    pred_geo: Optional[np.ndarray] = None,
    cell_size: int = 320,
) -> np.ndarray:
    """2×10 grid of training diagnostics, (2·cell, 10·cell, 3) uint8: the
    image (with the GT quads, when given, drawn through PIL), the score map
    and the 8 geometry channels (HWC maps); the GT row over the prediction
    row (black cells without a prediction)."""
    n_rows, n_cols = 2, 10
    collage = np.full((cell_size * n_rows, cell_size * n_cols, 3), 255, np.uint8)

    def row_cells(score, geo, quads):
        img = image_u8
        if quads is not None and len(quads):
            flat = [np.asarray(q).reshape(-1)[:8] for q in quads]
            img = np.array(draw_quads(image_u8, np.stack(flat), color=(0, 255, 0)))
        geo = np.asarray(geo)
        return [img, _colormap(np.asarray(score))] + [
            _colormap(geo[..., i]) for i in range(geo.shape[-1])
        ]

    rows = [row_cells(gt_score, gt_geo, gt_quads)]
    if pred_score is not None and pred_geo is not None:
        rows.append(row_cells(pred_score, pred_geo, None))
    else:
        rows.append([np.zeros((8, 8, 3), np.uint8)] * n_cols)
    for r, cells in enumerate(rows):
        for c in range(n_cols):
            collage[r * cell_size : (r + 1) * cell_size, c * cell_size : (c + 1) * cell_size] = (
                resize_u8(np.ascontiguousarray(cells[c]), cell_size, cell_size)
            )
    return collage


def visualize_page(
    image,
    page,
    *,
    show_order: bool = False,
    color: tuple = (0, 0, 255),
    thickness: int = 2,
    dark_alpha: float = 0.3,
    blur_ksize: int = 11,
    line_color: tuple = (0, 255, 0),
    number_color: tuple = (255, 255, 255),
    number_bg: tuple = (0, 0, 0),
):
    """A Page's words drawn on the image (an array or a PIL image) → PIL
    image; with ``show_order`` the word centres are joined in reading order
    and numbered from 1."""
    from PIL import Image, ImageDraw

    if isinstance(image, Image.Image):
        img = np.array(image.convert("RGB"))
    else:
        img = np.asarray(image).copy()
    words = [w for block in page.blocks for w in block.words]
    if not words:
        return Image.fromarray(img) if not isinstance(image, Image.Image) else image
    quads = np.stack([np.asarray(w.polygon, dtype=np.float32).reshape(-1) for w in words])
    out = draw_quads(img, quads, color=color, thickness=thickness,
                     dark_alpha=dark_alpha, blur_ksize=blur_ksize)
    if show_order:
        draw = ImageDraw.Draw(out)
        centers = []
        for w in words:
            xs = [p[0] for p in w.polygon]
            ys = [p[1] for p in w.polygon]
            centers.append((sum(xs) / len(xs), sum(ys) / len(ys)))
        for p, c in zip(centers, centers[1:]):
            draw.line([p, c], fill=tuple(line_color), width=3)
        for idx, (cx, cy) in enumerate(centers, start=1):
            draw.rectangle([cx - 12, cy - 12, cx + 12, cy + 12], fill=tuple(number_bg))
            draw.text((cx - 6, cy - 8), str(idx), fill=tuple(number_color))
    return out
