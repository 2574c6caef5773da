"""EAST detector wrapper (counterpart of ``manuscript_tpu/detectors/east.py``):
the network plus the configuration fields that phase A of the page path
reads, with the JAX wrapper's defaults. Loads a flax ``.msgpack`` checkpoint
with the port's own reader, or with ``allow_random_init=True`` fills the
model from a seeded generator; it never downloads anything. The network
computes in ``dtype`` (bfloat16 by default); score and geometry come out
float32."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import torch

from ..models.east import EASTModel
from ..utils.device import resolve_device
from ..utils.weights import init_random_, msgpack_restore, params_from_jax


class EAST:
    def __init__(
        self,
        weights_path: Optional[Union[str, Path]] = None,
        device: Optional[Union[str, torch.device]] = None,
        target_size: int = 1280,
        expand_ratio_w: float = 0.9,
        expand_ratio_h: float = 0.9,
        score_thresh: float = 0.6,
        iou_threshold: float = 0.2,
        score_geo_scale: float = 0.25,
        quantization: int = 2,
        axis_aligned_output: bool = True,
        remove_area_anomalies: bool = True,
        anomaly_sigma_threshold: float = 5.0,
        anomaly_min_box_count: int = 30,
        backbone: str = "resnet50",
        dtype: torch.dtype = torch.bfloat16,
        max_candidates: int = 8192,
        max_boxes: int = 1024,
        allow_random_init: bool = False,
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        self.target_size = target_size
        self.expand_ratio_w = expand_ratio_w
        self.expand_ratio_h = expand_ratio_h
        self.score_thresh = score_thresh
        self.iou_threshold = iou_threshold
        self.score_geo_scale = score_geo_scale
        self.quantization = quantization
        self.axis_aligned_output = axis_aligned_output
        self.remove_area_anomalies = remove_area_anomalies
        self.anomaly_sigma_threshold = anomaly_sigma_threshold
        self.anomaly_min_box_count = anomaly_min_box_count
        self.backbone = backbone
        self.dtype = dtype
        self.max_candidates = max_candidates
        self.max_boxes = max_boxes
        self.weights_path = weights_path

        self.model = EASTModel(backbone)
        if weights_path is not None:
            self.model.load_state_dict(params_from_jax(msgpack_restore(Path(weights_path))))
        elif allow_random_init:
            init_random_(self.model, seed)
        else:
            raise ValueError(
                "EAST needs weights_path=, or allow_random_init=True for untrained weights"
            )
        self.model.to(device=self.device, dtype=dtype).eval()
