"""Host box helpers of the page path (the port's copy of what it uses from
``manuscript_tpu/ops/boxes.py``)."""

from __future__ import annotations

import numpy as np


def quad_bbox_int(polygon: np.ndarray) -> tuple:
    """Integer axis-aligned bbox (x_min, y_min, x_max, y_max) of a polygon."""
    poly = np.asarray(polygon, dtype=np.int32)
    x_min, y_min = np.min(poly, axis=0)
    x_max, y_max = np.max(poly, axis=0)
    return (int(x_min), int(y_min), int(x_max), int(y_max))
