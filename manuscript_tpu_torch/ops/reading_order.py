"""Reading-order sorting of detected boxes (host, small-n).

The port's own copy of ``manuscript_tpu/ops/reading_order.py``.

Behavioral parity with the reference's line-clustering sort (reference:
src/manuscript/detectors/_east/utils.py:500-644): overlapping boxes are first
shrunk apart iteratively, then grouped into lines by y-center proximity and
sorted left-to-right within each line. O(n²) on at most a few hundred boxes —
kept on host by design (SURVEY.md §7 step 6).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Box = Tuple[int, int, int, int]  # (x_min, y_min, x_max, y_max)


def resolve_intersections(
    boxes: Sequence[Box], max_iterations: int = 50, max_boxes: int = 600
) -> List[Box]:
    """Shrink intersecting boxes by 10% per round until disjoint (or budget).

    The pair loop is O(n²) per round; beyond ``max_boxes`` boxes the
    resolution step is skipped (reading order then sorts the raw boxes) to
    keep pathological pages from stalling the pipeline."""
    if len(boxes) > max_boxes:
        return list(boxes)

    def intersect(b1, b2):
        return not (
            b1[2] <= b2[0] or b2[2] <= b1[0] or b1[3] <= b2[1] or b2[3] <= b1[1]
        )

    resolved = list(boxes)
    for _ in range(max_iterations):
        changed = False
        for i in range(len(resolved)):
            for j in range(i + 1, len(resolved)):
                if intersect(resolved[i], resolved[j]):
                    x0, y0, x1, y1 = resolved[i]
                    x0b, y0b, x1b, y1b = resolved[j]
                    resolved[i] = (
                        x0,
                        y0,
                        int(x1 - (x1 - x0) * 0.1),
                        int(y1 - (y1 - y0) * 0.1),
                    )
                    resolved[j] = (
                        x0b,
                        y0b,
                        int(x1b - (x1b - x0b) * 0.1),
                        int(y1b - (y1b - y0b) * 0.1),
                    )
                    changed = True
        if not changed:
            break
    return resolved


def sort_boxes_reading_order(
    boxes: Sequence[Box],
    y_tol_ratio: float = 0.6,
    x_gap_ratio: float = np.inf,
) -> List[Box]:
    """Group boxes into lines by vertical proximity, then sort left-to-right.

    A box joins an existing line when its y-center is within
    ``avg_height * y_tol_ratio`` of the line's mean y-center and its left edge
    is within ``avg_height * x_gap_ratio`` of the line's rightmost edge.
    """
    if not boxes:
        return []

    avg_h = np.mean([b[3] - b[1] for b in boxes])
    lines: List[List[Box]] = []

    for b in sorted(boxes, key=lambda b: (b[1] + b[3]) / 2):
        cy = (b[1] + b[3]) / 2
        placed = False
        for ln in lines:
            line_cy = np.mean([(v[1] + v[3]) / 2 for v in ln])
            last_x1 = max(v[2] for v in ln)
            if (
                abs(cy - line_cy) <= avg_h * y_tol_ratio
                and (b[0] - last_x1) <= avg_h * x_gap_ratio
            ):
                ln.append(b)
                placed = True
                break
        if not placed:
            lines.append([b])

    lines.sort(key=lambda ln: np.mean([(b[1] + b[3]) / 2 for b in ln]))
    for ln in lines:
        ln.sort(key=lambda b: b[0])
    return [b for ln in lines for b in ln]


def sort_boxes_reading_order_with_resolutions(
    boxes: Sequence[Box],
    y_tol_ratio: float = 0.6,
    x_gap_ratio: float = np.inf,
) -> List[Box]:
    """Reading-order sort applied after intersection resolution; returns the
    *original* boxes in the resolved order."""
    compressed = resolve_intersections(boxes)
    mapping = {c: o for c, o in zip(compressed, boxes)}
    sorted_compressed = sort_boxes_reading_order(
        compressed, y_tol_ratio=y_tol_ratio, x_gap_ratio=x_gap_ratio
    )
    return [mapping[b] for b in sorted_compressed]


def reading_order_permutation(
    boxes: Sequence[Box],
    y_tol_ratio: float = 0.6,
    x_gap_ratio: float = np.inf,
) -> List[int]:
    """Index permutation for reading order — avoids the reference's O(n²)
    exact-tuple rematch when reordering Word objects (reference:
    src/manuscript/_pipeline.py:113-123; same ordering semantics, better
    algorithm per SURVEY.md §7 quirks)."""
    if not boxes:
        return []
    compressed = resolve_intersections(boxes)
    order_map = {}
    for i, c in enumerate(compressed):
        # first-wins for duplicate shrunken boxes, matching dict-overwrite
        # semantics of the reference's mapping build (later keys overwrite,
        # but the reference then matches the *original* box by equality with
        # first-match-wins; permutation reproduces observable word order).
        order_map.setdefault(c, []).append(i)
    sorted_compressed = sort_boxes_reading_order(
        compressed, y_tol_ratio=y_tol_ratio, x_gap_ratio=x_gap_ratio
    )
    perm: List[int] = []
    used = set()
    for c in sorted_compressed:
        for idx in order_map.get(c, []):
            if idx not in used:
                perm.append(idx)
                used.add(idx)
                break
    # Any boxes lost to duplicate-key collisions keep their original order.
    for i in range(len(boxes)):
        if i not in used:
            perm.append(i)
    return perm
