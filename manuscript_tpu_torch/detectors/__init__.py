from ..ops.boxes import expand_boxes
from ..ops.decode import decode_quads_numpy as decode_quads_from_maps
from ..ops.lanms import locality_aware_nms, standard_nms
from .east import EAST

__all__ = ["EAST", "decode_quads_from_maps", "expand_boxes", "locality_aware_nms", "standard_nms"]
