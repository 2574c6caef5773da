"""Page OCR on the native-crop path (counterpart of ``manuscript_tpu/fused.py``,
``FusedOCR`` with ``crop_source="native"``).

One page runs four stages:

* phase A on the device: normalize → EAST → cell decode → candidate
  compaction → parallel LANMS → expand/rescale/containment/anomaly/
  axis-align; the boxes (score −1 marks an invalid row) come to the host;
* host crops: each eligible word's axis-aligned box is sliced from the
  original page and resized onto a white canvas, into one strip of ``nw``
  slots (``nw`` from the capacity buckets);
* phase B on the device: TRBA encode → greedy or beam decode →
  confidences;
* the page build: token decode, reading order, ``Page``/``Block``/``Word``.

The upload is the plain uint8 page: the JAX package's row-delta and
channel-fold transport is a lossless trick for its TPU link and gives the
same bytes on the device. At most ``max_words`` words are recognized; further
words keep their boxes and get no text. With ``max_words="auto"`` the first
page's eligible-word count, from a phase-A run at the configured
``max_boxes``, picks the capacity bucket and shrinks ``max_boxes``; phase A
then runs again at that size. A denser page later grows the bucket.
"""

from __future__ import annotations

import time
from typing import List, Tuple, Union

import numpy as np
import torch

from .ops.boxes import quad_bbox_int
from .ops.decode import compact_candidates, decode_cells
from .ops.image import crop_axis_aligned, detector_preprocess_host, read_image, resize_and_pad
from .ops.lanms_torch import locality_aware_nms_parallel
from .ops.postprocess_torch import postprocess_boxes
from .ops.reading_order import reading_order_permutation
from .types import Block, Page, Word


class FusedOCR:
    CAPACITY_BUCKETS = (32, 64, 128, 256)  # word slots per phase-B call
    CAPACITY_HEADROOM = 8  # spare slots a bucket keeps (fewer for small ones)

    def __init__(
        self,
        detector,
        recognizer,
        max_words: Union[int, str] = "auto",
        mode: str = "beam",
        beam_size: int = 8,
        alpha: float = 0.9,
        temperature: float = 1.7,
        min_text_size: int = 5,
    ):
        if mode not in ("greedy", "beam"):
            raise ValueError(f"Unknown mode: {mode}")
        if max_words != "auto" and not isinstance(max_words, int):
            raise ValueError(f"max_words must be an int or 'auto': {max_words!r}")
        self.detector = detector
        self.recognizer = recognizer
        self._auto_capacity = max_words == "auto"
        self.max_words = None if self._auto_capacity else max_words
        self.mode = mode
        self.beam_size = beam_size
        self.alpha = alpha
        self.temperature = temperature
        self.min_text_size = min_text_size
        self._orig_max_boxes = detector.max_boxes
        self.last_dropped = 0
        self.last_overflow = 0  # words over capacity on the last overflowing page
        self.last_timings = {}  # host-clock seconds of the last page's stages

    # ---- phase A ---------------------------------------------------------

    @torch.inference_mode()
    def detect(self, resized: np.ndarray, scale_x: float, scale_y: float):
        """Phase A on a (target, target, 3) uint8 page → (boxes9 (nb, 9) with
        score −1 on invalid rows, validity (nb,), eligible-word count)."""
        det = self.detector
        x = torch.from_numpy(np.ascontiguousarray(resized)).to(det.device)
        x = (x.to(det.dtype) / 255.0 - 0.5) / 0.5
        out = det.model(x[None])
        score = out["score"][0, :, :, 0]
        geo = out["geometry"][0]
        quads, scores, valid = decode_cells(
            score, geo, det.score_thresh, det.quantization, 1.0 / det.score_geo_scale
        )
        cands = compact_candidates(quads, scores, valid, det.max_candidates)
        merged, count = locality_aware_nms_parallel(cands, det.iou_threshold, det.max_boxes)
        boxes9, bvalid = postprocess_boxes(
            merged, count, det.expand_ratio_w, det.expand_ratio_h, scale_x, scale_y,
            axis_aligned=det.axis_aligned_output,
            remove_anomalies=det.remove_area_anomalies,
            anomaly_sigma=det.anomaly_sigma_threshold,
            anomaly_min_count=det.anomaly_min_box_count,
        )
        boxes9[:, 8] = torch.where(bvalid, boxes9[:, 8], torch.full_like(boxes9[:, 8], -1.0))
        boxes9 = boxes9.cpu().numpy()
        bvalid = boxes9[:, 8] >= 0.0
        return boxes9, bvalid, len(self._eligible_rows(boxes9, bvalid))

    # ---- word capacity -----------------------------------------------------

    def _headroom(self, cap: int) -> int:
        return min(self.CAPACITY_HEADROOM, max(2, cap // 8))

    def _apply_capacity(self, n_words: int) -> None:
        cap = next(
            (c for c in self.CAPACITY_BUCKETS if n_words <= c - self._headroom(c)),
            self.CAPACITY_BUCKETS[-1],
        )
        self.max_words = cap
        # box capacity follows the word capacity (4× headroom, at least 256),
        # never above the detector's configured bound
        self.detector.max_boxes = min(self._orig_max_boxes, max(4 * cap, 256))

    def _native_capacity_for(self, n_eligible: int) -> int:
        nw = self.max_words
        if n_eligible > nw and self._auto_capacity:
            grown = next(
                (
                    c
                    for c in self.CAPACITY_BUCKETS
                    if c > nw and n_eligible <= c - self._headroom(c)
                ),
                self.CAPACITY_BUCKETS[-1],
            )
            if grown > nw:
                self.last_overflow = n_eligible - nw
                self.max_words = nw = grown
        return nw

    def _chunk_bucket(self, max_elig: int) -> int:
        """Smallest bucket covering this page's eligible words, capped at the
        (possibly grown) global bound."""
        cap = self._native_capacity_for(max_elig)
        nw = next((c for c in self.CAPACITY_BUCKETS if c >= max_elig), cap)
        return min(nw, cap)

    # ---- host crops ----------------------------------------------------------

    def _eligible_rows(self, boxes9: np.ndarray, bvalid: np.ndarray) -> np.ndarray:
        """Valid rows whose floor'd axis-aligned extent is ≥ min_text_size."""
        bq = boxes9[:, :8].reshape(-1, 4, 2)
        x_min, x_max = np.floor(bq[..., 0].min(axis=1)), np.floor(bq[..., 0].max(axis=1))
        y_min, y_max = np.floor(bq[..., 1].min(axis=1)), np.floor(bq[..., 1].max(axis=1))
        big = ((x_max - x_min) >= self.min_text_size) & ((y_max - y_min) >= self.min_text_size)
        return np.nonzero(bvalid & big)[0]

    def _native_strip(self, img: np.ndarray, boxes9: np.ndarray, rows, nw: int) -> np.ndarray:
        """(nw, img_h, img_w, 3) uint8 crops; unused slots stay white (they
        are decoded too, and their outputs dropped)."""
        rec = self.recognizer
        strip = np.full((nw, rec.img_h, rec.img_w, 3), 255, np.uint8)
        for s, r in enumerate(rows):
            poly = boxes9[int(r), :8].reshape(4, 2).astype(np.int32)
            region = crop_axis_aligned(img, poly)
            if region is not None and region.size > 0:
                strip[s] = resize_and_pad(region, rec.img_h, rec.img_w)
        return strip

    # ---- phase B -------------------------------------------------------------

    def recognize(self, crops: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Phase B: (nw, img_h, img_w, 3) uint8 → (confs, token ids)."""
        preds, confs = self.recognizer.recognize_u8(
            crops, self.mode, self.beam_size, self.alpha, self.temperature
        )
        return confs, preds

    # ---- page ----------------------------------------------------------------

    def predict(self, image) -> Page:
        det = self.detector
        t0 = time.perf_counter()
        img = read_image(image)
        resized = detector_preprocess_host(img, det.target_size)
        sx = img.shape[1] / det.target_size
        sy = img.shape[0] / det.target_size
        t1 = time.perf_counter()
        if self.max_words is None:  # auto capacity: count on the first page
            self._apply_capacity(self.detect(resized, sx, sy)[2])
        boxes9, bvalid, _ = self.detect(resized, sx, sy)
        t2 = time.perf_counter()
        rows_all = self._eligible_rows(boxes9, bvalid)
        nw = self._chunk_bucket(len(rows_all))
        rows = rows_all[:nw]
        self.last_dropped = len(rows_all) - len(rows)
        if self.last_dropped > 0:
            self.last_overflow = self.last_dropped
        strip = self._native_strip(img, boxes9, rows, nw)
        t3 = time.perf_counter()
        confs, preds = self.recognize(strip)
        t4 = time.perf_counter()
        page = self._build_page_result(boxes9, bvalid, rows, preds, confs)
        t5 = time.perf_counter()
        self.last_timings = {
            "preprocess": t1 - t0, "detect": t2 - t1, "crops": t3 - t2,
            "recognize": t4 - t3, "page_build": t5 - t4, "slots": nw,
        }
        return page

    def _build_page_result(self, boxes9, bvalid, rows, preds, confs) -> Page:
        rec = self.recognizer
        words: List[Word] = []
        row_to_word = {}
        for row in np.nonzero(bvalid)[0]:
            quad = boxes9[row]
            word = Word(
                polygon=quad[:8].reshape(4, 2).tolist(),
                detection_confidence=float(np.clip(quad[8], 0.0, 1.0)),
            )
            row_to_word[int(row)] = word
            words.append(word)
        for s, row in enumerate(rows):
            word = row_to_word[int(row)]
            word.text = rec.decode(preds[s])
            word.recognition_confidence = float(np.clip(confs[s], 0.0, 1.0))
        if words:
            boxes = [quad_bbox_int(np.asarray(w.polygon, dtype=np.int32)) for w in words]
            words = [words[i] for i in reading_order_permutation(boxes)]
        return Page(blocks=[Block(words=words)])
