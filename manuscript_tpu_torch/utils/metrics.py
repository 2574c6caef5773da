"""Edit distance and detection F1 (counterpart of
``manuscript_tpu/train/metrics.py``: ``_levenshtein_generic``,
``_edit_distance``, ``poly_iou``, ``compute_f1``).

The JAX package uses ``python-Levenshtein`` when it is installed; the port
always uses the generic dynamic programme, which gives the same integers.
Detection F1 matches each prediction greedily to the unused ground-truth
polygon of highest IoU (``ops.geometry.polygon_iou``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..ops.geometry import polygon_iou


def _levenshtein_generic(a: Sequence, b: Sequence) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        curr = [i]
        for j, cb in enumerate(b, 1):
            curr.append(min(prev[j] + 1, curr[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = curr
    return prev[-1]


def _edit_distance(a: str, b: str) -> int:
    return _levenshtein_generic(list(a), list(b))


def poly_iou(seg_a, seg_b) -> float:
    """IoU of two polygons given as flat coordinate lists or (N, 2) arrays."""
    a = np.asarray(seg_a, dtype=np.float64).reshape(-1, 2)
    b = np.asarray(seg_b, dtype=np.float64).reshape(-1, 2)
    if a.shape[0] < 3 or b.shape[0] < 3:
        return 0.0
    return polygon_iou(a, b)


def compute_f1(
    preds: List[Dict],
    thresh: float,
    gt_segs: Dict,
    processed_ids: Sequence,
) -> float:
    """Greedy-matched detection F1 at one IoU threshold. ``preds``:
    [{"image_id", "segmentation": flat coords}]; ``gt_segs``: {image_id:
    [flat coords, …]}."""
    used = {iid: [False] * len(gt_segs.get(iid, [])) for iid in processed_ids}
    tp = fp = 0
    for p in preds:
        iid = p["image_id"]
        best_iou, best_j = 0.0, -1
        for j, gt in enumerate(gt_segs.get(iid, [])):
            if used[iid][j]:
                continue
            iou = poly_iou(p["segmentation"], gt)
            if iou > best_iou:
                best_iou, best_j = iou, j
        if best_iou >= thresh:
            tp += 1
            used[iid][best_j] = True
        else:
            fp += 1
    total_gt = sum(len(v) for v in gt_segs.values())
    fn = total_gt - tp
    prec = tp / (tp + fp) if tp + fp > 0 else 0.0
    rec = tp / (tp + fn) if tp + fn > 0 else 0.0
    return 2 * prec * rec / (prec + rec) if (prec + rec) > 0 else 0.0
