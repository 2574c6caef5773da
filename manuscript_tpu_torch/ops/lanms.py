"""Locality-aware NMS on the host (counterpart of ``manuscript_tpu/ops/lanms.py``).

Candidates sorted by x0 (stable) are merged one after another into the
running merged quad while their IoU with it exceeds the threshold (a
score-weighted vertex average after vertex-order normalisation); a greedy
score-descending NMS then runs over the merged quads.

``locality_aware_nms`` runs the C++ library built from ``csrc/lanms.cpp``
(``ops/_build.py``, the host C++ compiler, at first use) and raises when it
cannot be built or loaded: there is no silent fallback. The numpy version
beside it computes the same rows and is the plain twin the tests hold the
library to; it is far slower (seconds at a few thousand candidates).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from . import _build
from .geometry import normalize_polygon, should_merge

_EMPTY = np.zeros((0, 9), dtype=np.float32)


def standard_nms(polys, scores, iou_threshold: float) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy score-descending NMS over quads (n, 4, 2) → kept (polys,
    scores), float64."""
    polys_arr = np.ascontiguousarray(polys, dtype=np.float64)
    scores_arr = np.ascontiguousarray(scores, dtype=np.float64)
    if polys_arr.size == 0:
        return polys_arr, scores_arr
    order = np.argsort(-scores_arr)
    n = order.shape[0]
    # disjoint bounding boxes have IoU 0: no clip for them
    x0, x1 = polys_arr[:, :, 0].min(1), polys_arr[:, :, 0].max(1)
    y0, y1 = polys_arr[:, :, 1].min(1), polys_arr[:, :, 1].max(1)
    suppressed = np.zeros(polys_arr.shape[0], dtype=bool)
    keep = []
    for i in range(n):
        idx = order[i]
        if suppressed[idx]:
            continue
        keep.append(idx)
        for j in range(i + 1, n):
            jdx = order[j]
            if suppressed[jdx]:
                continue
            if x1[idx] < x0[jdx] or x1[jdx] < x0[idx] or y1[idx] < y0[jdx] or y1[jdx] < y0[idx]:
                continue
            if should_merge(polys_arr[idx], polys_arr[jdx], iou_threshold):
                suppressed[jdx] = True
    keep = np.asarray(keep, dtype=np.int64)
    return polys_arr[keep], scores_arr[keep]


def locality_aware_nms_numpy(boxes: np.ndarray, iou_threshold: float) -> np.ndarray:
    """LANMS in numpy: (n, 9) rows [x0..y3, score] → (m, 9) float32."""
    if boxes is None or len(boxes) == 0:
        return _EMPTY.copy()
    boxes = np.asarray(boxes)
    boxes_sorted = np.ascontiguousarray(boxes, dtype=np.float64)[np.argsort(boxes[:, 0])]

    merged_polys, merged_scores, weight_sums = [], [], []
    for row in boxes_sorted:
        poly = row[:8].reshape(4, 2)
        score = float(row[8])
        if merged_polys:
            last = merged_polys[-1]
            if should_merge(poly, last, iou_threshold):
                aligned = normalize_polygon(last, poly)
                total_w = weight_sums[-1] + score
                merged_polys[-1] = (last * weight_sums[-1] + aligned * score) / total_w
                weight_sums[-1] = total_w
                merged_scores[-1] = max(merged_scores[-1], score)
                continue
        merged_polys.append(poly.copy())
        merged_scores.append(score)
        weight_sums.append(score)

    kept_polys, kept_scores = standard_nms(
        np.stack(merged_polys), np.asarray(merged_scores, dtype=np.float64), iou_threshold
    )
    if kept_polys.size == 0:
        return _EMPTY.copy()
    out = np.concatenate([kept_polys.reshape(kept_polys.shape[0], -1), kept_scores[:, None]], axis=1)
    return out.astype(np.float32)


def _lib() -> ctypes.CDLL:
    lib = _build.library("lanms")
    if lib.lanms.argtypes is None:
        dptr = ctypes.POINTER(ctypes.c_double)
        lib.lanms.argtypes = [dptr, ctypes.c_int64, ctypes.c_double, dptr]
        lib.lanms.restype = ctypes.c_int64
    return lib


def locality_aware_nms(boxes: np.ndarray, iou_threshold: float) -> np.ndarray:
    """LANMS over (n, 9) quad + score rows in the C++ library → (m, 9)
    float32 (raises when the library cannot be built or loaded)."""
    lib = _lib()
    if boxes is None or len(boxes) == 0:
        return _EMPTY.copy()
    arr = np.ascontiguousarray(np.asarray(boxes), dtype=np.float64)
    if arr.ndim != 2 or arr.shape[1] != 9:
        raise ValueError(f"lanms: boxes must be (n, 9), got {arr.shape}")
    n = arr.shape[0]
    out = np.empty((n, 9), dtype=np.float64)
    dptr = ctypes.POINTER(ctypes.c_double)
    m = lib.lanms(arr.ctypes.data_as(dptr), n, float(iou_threshold), out.ctypes.data_as(dptr))
    if m == 0:
        return _EMPTY.copy()
    return out[:m].astype(np.float32)


# the JAX package's name for its C++ entry; here the C++ library is the only one
locality_aware_nms_native = locality_aware_nms


def native_available() -> bool:
    """Whether the C++ LANMS builds (or is built) and loads here."""
    try:
        _lib()
    except (OSError, RuntimeError):
        return False
    return True
