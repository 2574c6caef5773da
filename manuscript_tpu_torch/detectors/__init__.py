from ..ops.boxes import expand_boxes
from ..ops.decode import decode_quads_numpy as decode_quads_from_maps
from ..ops.image import read_image
from ..ops.lanms import locality_aware_nms, standard_nms
from ..ops.reading_order import (
    resolve_intersections,
    sort_boxes_reading_order,
    sort_boxes_reading_order_with_resolutions,
)
from ..types import Block, Page, Word
from ..utils.visualize import draw_quads, visualize_page
from .east import EAST

# the reference's older name of the detector
EASTInfer = EAST

__all__ = [
    "EAST",
    "EASTInfer",
    "Word",
    "Block",
    "Page",
    "read_image",
    "visualize_page",
    "draw_quads",
    "locality_aware_nms",
    "standard_nms",
    "decode_quads_from_maps",
    "expand_boxes",
    "sort_boxes_reading_order",
    "sort_boxes_reading_order_with_resolutions",
    "resolve_intersections",
]
