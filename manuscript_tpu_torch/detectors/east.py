"""EAST detector wrapper (counterpart of ``manuscript_tpu/detectors/east.py``),
with the JAX wrapper's defaults and its ``predict``/``predict_batch`` API.

Weights, in this order: ``weights_path``; the first ``.msgpack``, else
``.pth``, under ``~/.manuscript_tpu/east`` (``MANUSCRIPT_TPU_CACHE``); the
reference's released ``.pth``, fetched into that cache on first use
(``utils/weights.fetch_artifact``; ``MANUSCRIPT_TPU_NO_DOWNLOAD=1`` turns the
fetch off). A flax ``.msgpack`` is read with the port's own reader, a
``.pth`` converted (``utils/convert.py``). With none of these, weights from
a seeded generator only when ``allow_random_init`` (by default
``MANUSCRIPT_TPU_ALLOW_RANDOM_INIT=1``) allows them; else the constructor
raises. The network computes in ``dtype`` (bfloat16 by default); score and
geometry come out float32. ``vis=True`` adds the page drawn by
``utils/visualize.visualize_page`` (PIL) as ``"vis_image"``.

``predict`` per page: the host resizes the page to target² uint8; on the
device the network, the cell decode and the candidate compaction run; then

* ``nms="host"`` (default): the candidates come to the host, where the C++
  LANMS (``ops/lanms.py``) and the numpy box chain (expansion, rescale,
  containment and anomaly filters, axis alignment; ``ops/boxes.py``) run;
* ``nms="device"``: the scan LANMS (``ops/lanms_torch.locality_aware_nms``,
  kernel K3 and K2 on the card) and the post-processing
  (``ops/postprocess_torch.py``) stay on the device and only the boxes come
  back.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..models.east import EASTModel
from ..ops.boxes import (
    expand_boxes,
    quad_bbox_int,
    remove_area_anomalies,
    remove_fully_contained,
    scale_boxes,
    to_axis_aligned,
)
from ..ops.decode import compact_candidates, compact_topk, decode_cells
from ..ops.image import detector_preprocess_host, normalize_u8, read_image
from ..ops.lanms import locality_aware_nms
from ..ops.lanms_torch import locality_aware_nms as device_lanms
from ..ops.postprocess_torch import postprocess_boxes
from ..ops.reading_order import reading_order_permutation
from ..parallel.mesh import (
    DATA_AXIS,
    all_gather_rows,
    on_device,
    one_device_mesh,
    replicate,
    shard_batch,
)
from ..types import Block, Page, Word
from ..utils.device import resolve_device
from ..utils.visualize import visualize_page
from ..utils.weights import (
    MissingWeightsError,
    allow_random_init_default,
    cached_checkpoint,
    fetch_artifact,
    init_random_,
    msgpack_restore,
    msgpack_serialize,
    params_from_jax,
    params_to_jax,
)


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
        nms: str = "host",
        max_boxes: int = 1024,
        allow_random_init: Optional[bool] = None,
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
        if nms not in ("host", "device"):
            raise ValueError(f"nms must be 'host' or 'device', got {nms!r}")
        self.nms = nms
        self.max_boxes = max_boxes
        self.last_timings: Dict[str, float] = {}  # host-clock stage seconds of the last predict

        if weights_path is not None and not os.path.exists(str(weights_path)):
            raise FileNotFoundError(f"Weights not found: {weights_path}")
        if weights_path is None:
            weights_path = cached_checkpoint("east") or fetch_artifact("east")
        if allow_random_init is None:
            allow_random_init = allow_random_init_default()
        self.weights_path = weights_path
        self.allow_random_init = allow_random_init

        self.model = EASTModel(backbone)
        if weights_path is not None and str(weights_path).endswith(".pth"):
            from ..utils.convert import convert_east, load_torch_state_dict, merge_converted

            state = load_torch_state_dict(str(weights_path))
            self.model.load_state_dict(
                merge_converted(self.model.state_dict(), convert_east(state, backbone))
            )
        elif weights_path is not None:
            self.model.load_state_dict(params_from_jax(msgpack_restore(Path(weights_path))))
        elif allow_random_init:
            init_random_(self.model, seed)
        else:
            raise MissingWeightsError(
                "EAST found no checkpoint (none given, none in ~/.manuscript_tpu/east, "
                "and the release could not be fetched): pass weights_path=, or "
                "allow_random_init=True (or set MANUSCRIPT_TPU_ALLOW_RANDOM_INIT=1) "
                "for untrained weights"
            )
        self.model.to(device=self.device, dtype=dtype).eval()
        self._mesh_models: Dict[Any, List[EASTModel]] = {}

    def save(self, path: Union[str, Path]) -> None:
        """Write the model's variables as a flax ``.msgpack`` checkpoint
        ({"params", "batch_stats"}, float32): the port's and the JAX
        package's ``EAST(weights_path=...)`` load it."""
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_bytes(msgpack_serialize(params_to_jax(self.model.state_dict())))

    @staticmethod
    def train(*args, **kwargs):
        """Train a detector (``train/east_train.train``; on the card unless
        ``device="cpu"``)."""
        from ..train.east_train import train as _train

        return _train(*args, **kwargs)

    # ---- device stages -------------------------------------------------------

    def maps(self, pages: torch.Tensor, model: Optional[EASTModel] = None):
        """(B, target, target, 3) uint8 pages on the device → score (B, h, w)
        and geometry (B, h, w, 8), float32. ``model``: a copy of the
        wrapper's model on the pages' device (a mesh's replica), else the
        wrapper's own."""
        out = (self.model if model is None else model)(normalize_u8(pages, self.dtype))
        return out["score"][..., 0], out["geometry"]

    def candidates(self, score: torch.Tensor, geo: torch.Tensor, score_thresh=None) -> torch.Tensor:
        """Maps → ([B,] max_candidates, 9) candidate rows (score −1 on
        padding). ``score_thresh``: the detector's by default, or one per page."""
        thresh = self.score_thresh if score_thresh is None else score_thresh
        quads, scores, valid = decode_cells(
            score, geo, thresh, self.quantization, 1.0 / self.score_geo_scale
        )
        return compact_candidates(quads, scores, valid, self.max_candidates)

    def _upload(self, resized: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(resized)).to(self.device)

    # ---- host stages -----------------------------------------------------------

    def _box_chain(self, nms_quads: np.ndarray, orig_h: int, orig_w: int) -> np.ndarray:
        """Host post-processing of one page's LANMS rows → output quads."""
        expanded = expand_boxes(nms_quads, expand_w=self.expand_ratio_w, expand_h=self.expand_ratio_h)
        processed = remove_fully_contained(scale_boxes(expanded, self.target_size, orig_h, orig_w))
        if self.remove_area_anomalies:
            processed = remove_area_anomalies(
                processed, sigma_threshold=self.anomaly_sigma_threshold,
                min_box_count=self.anomaly_min_box_count,
            )
        return to_axis_aligned(processed) if self.axis_aligned_output else processed

    # ---- public API ----------------------------------------------------------------

    @torch.inference_mode()
    def predict(
        self,
        img_or_path: Union[str, Path, np.ndarray],
        vis: bool = False,
        profile: bool = False,
        return_maps: bool = False,
        sort_reading_order: bool = False,
    ) -> Dict[str, Any]:
        """Detect text → {"page", "vis_image", "score_map", "geo_map"}
        (``geo_map`` as (8, h, w)). ``last_timings`` then holds the host-clock
        seconds of the stages: ``prep`` (read and resize), ``forward`` (the
        launch of network, decode and compaction; with ``nms="device"`` also
        NMS and post-processing), ``fetch`` (the wait for the device and the
        copy), ``lanms`` and ``boxes`` (the host LANMS and box chain)."""
        t = [time.perf_counter()]
        img = read_image(img_or_path)
        orig_h, orig_w = img.shape[:2]
        x = self._upload(detector_preprocess_host(img, self.target_size))[None]
        t.append(time.perf_counter())
        score, geo = self.maps(x)
        cands = self.candidates(score, geo)[0]
        if self.nms == "device" and not return_maps:
            boxes, count = device_lanms(cands, self.iou_threshold, self.max_boxes)
            boxes9, valid = postprocess_boxes(
                boxes, count, self.expand_ratio_w, self.expand_ratio_h,
                orig_w / self.target_size, orig_h / self.target_size,
                axis_aligned=self.axis_aligned_output,
                remove_anomalies=self.remove_area_anomalies,
                anomaly_sigma=self.anomaly_sigma_threshold,
                anomaly_min_count=self.anomaly_min_box_count,
            )
            t.append(time.perf_counter())
            boxes9, valid = boxes9.cpu().numpy(), valid.cpu().numpy()
            output = boxes9[valid]
            t.append(time.perf_counter())
            names = ("prep", "forward", "fetch")
        else:
            t.append(time.perf_counter())
            cands_np = cands.cpu().numpy()  # the one copy of the page's result
            t.append(time.perf_counter())
            nms_quads = locality_aware_nms(compact_topk(cands_np), self.iou_threshold)
            t.append(time.perf_counter())
            output = self._box_chain(nms_quads, orig_h, orig_w)
            t.append(time.perf_counter())
            names = ("prep", "forward", "fetch", "lanms", "boxes")
        self.last_timings = {n: b - a for n, a, b in zip(names, t, t[1:])}
        if profile:
            print("  " + ", ".join(f"{n} {s:.3f}s" for n, s in self.last_timings.items())
                  + f"; boxes out: {len(output)}")
        return self._build_result(
            img if vis else None, output, sort_reading_order,
            (score[0], geo[0]) if return_maps else None,
        )

    @torch.inference_mode()
    def predict_batch(
        self,
        images,
        batch_size: int = 4,
        vis: bool = False,
        profile: bool = False,
        sort_reading_order: bool = False,
        mesh=None,
    ) -> List[Dict[str, Any]]:
        """Detect over many pages: one batched forward, decode and compaction
        per chunk of ``batch_size`` pages on the device (every chunk launched
        before the first is fetched), then the host LANMS and box chain per
        page. Returns one result dict per page, as ``predict``. ``mesh``
        (``parallel.make_mesh``) shards each chunk's pages over its data
        axis, on copies of the model made once per mesh: ``batch_size``
        rounds up to a multiple of the data-axis size and a short chunk
        repeats its last page to one. Under a process group every rank
        passes the same pages and gets every page's result. Without a mesh
        the chunks run on the 1 × 1 mesh of the wrapper's device with its
        own model, and a short chunk is not padded: nothing is compiled for
        a batch size."""
        if mesh is None:  # the wrapper's own model on its device
            mesh, models = one_device_mesh(self.device), [self.model]
        else:
            if mesh not in self._mesh_models:
                self._mesh_models[mesh] = replicate(self.model, mesh)
            models = self._mesh_models[mesh]
        n_data = mesh.shape[DATA_AXIS]
        batch_size = max(n_data, -(-batch_size // n_data) * n_data)
        loaded = [read_image(im) for im in images]
        pending = []
        for start in range(0, len(loaded), batch_size):
            chunk = loaded[start : start + batch_size]
            x = np.stack([detector_preprocess_host(im, self.target_size) for im in chunk])
            x = np.concatenate([x, x[-1:].repeat((-len(chunk)) % n_data, axis=0)])
            cands = []
            for (_, dev), model, (piece,) in zip(mesh.local_shards, models,
                                                  shard_batch((x,), mesh)):
                with on_device(dev):
                    cands.append(all_gather_rows(self.candidates(*self.maps(piece, model)), mesh))
            pending.append((start, chunk, cands))
        results = []
        for start, chunk, cands in pending:
            t0 = time.perf_counter()
            cands_np = np.concatenate([c.cpu().numpy() for c in cands])[: len(chunk)]
            if profile:
                print(f"  Batched detect sync [{start}:{start + len(chunk)}]: "
                      f"{time.perf_counter() - t0:.3f}s")
            for img, c in zip(chunk, cands_np):
                nms_quads = locality_aware_nms(compact_topk(c), self.iou_threshold)
                output = self._box_chain(nms_quads, *img.shape[:2])
                results.append(self._build_result(img if vis else None, output, sort_reading_order, None))
        return results

    def _build_result(self, vis_img, output_quads: np.ndarray, sort_reading_order: bool,
                      maps) -> Dict[str, Any]:
        """The result dict; ``vis_img`` (the page, or None) is drawn with the
        words, without reading-order numbers."""
        words = [
            Word(
                polygon=quad[:8].reshape(4, 2).tolist(),
                detection_confidence=float(np.clip(quad[8], 0.0, 1.0)),
            )
            for quad in output_quads
        ]
        if sort_reading_order and words:
            boxes = [quad_bbox_int(np.asarray(w.polygon, dtype=np.int32)) for w in words]
            words = [words[i] for i in reading_order_permutation(boxes)]
        page = Page(blocks=[Block(words=words)])
        return {
            "page": page,
            "vis_image": None if vis_img is None else visualize_page(vis_img, page, show_order=False),
            "score_map": None if maps is None else maps[0].cpu().numpy(),
            "geo_map": None if maps is None else maps[1].permute(2, 0, 1).cpu().numpy(),
        }
