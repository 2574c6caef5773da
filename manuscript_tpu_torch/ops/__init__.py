"""Tensor ops of the page path. ``attention_step`` and ``quad_iou`` hold the
hand-written CUDA kernels (sources in ``../csrc``) beside their plain twins.

The package exports the names that ``manuscript_tpu.ops`` exports, under the
port's names where they differ: ``decode_cells`` is the JAX package's
``decode_cells_jax``."""

from .boxes import (
    expand_boxes,
    quad_to_rbox,
    remove_area_anomalies,
    remove_fully_contained,
    scale_boxes,
    to_axis_aligned,
)
from .decode import compact_decoded, decode_cells, decode_quads_numpy
from .geometry import (
    clip_polygon,
    compute_intersection,
    normalize_polygon,
    point_in_polygon,
    polygon_area,
    polygon_intersection,
    polygon_iou,
    should_merge,
)
from .image import (
    batch_resize_and_pad,
    crop_axis_aligned,
    detector_preprocess_host,
    normalize_u8,
    read_image,
    resize_and_pad,
    resize_bilinear,
)
from .lanms import (
    locality_aware_nms,
    locality_aware_nms_native,
    locality_aware_nms_numpy,
    native_available,
    standard_nms,
)
from .reading_order import (
    reading_order_permutation,
    resolve_intersections,
    sort_boxes_reading_order,
    sort_boxes_reading_order_with_resolutions,
)
