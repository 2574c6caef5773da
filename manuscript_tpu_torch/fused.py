"""Page OCR, one page or many (counterpart of ``manuscript_tpu/fused.py``,
``FusedOCR``).

``crop_source`` picks where the recognizer's crops come from:

* ``"native"`` (default), four stages per chunk of up to ``batch_pages``
  pages:

  - phase A on the device: normalize → EAST → cell decode → candidate
    compaction → parallel LANMS → expand/rescale/containment/anomaly/
    axis-align, for all pages of the chunk in one pass; the boxes (score −1
    marks an invalid row) come to the host;
  - host crops: each eligible word's axis-aligned box is sliced from the
    original page and resized onto a white canvas, into one strip of ``nw``
    slots per page (``nw`` from the capacity buckets, one per chunk);
  - phase B on the device: TRBA encode → greedy or beam decode →
    confidences, for the chunk's B·nw slots in one pass;
  - the page build: token decode, reading order, ``Page``/``Block``/``Word``,
    and with ``vis`` the page drawn by ``utils/visualize.visualize_page``.

* ``"device"``: one program per chunk: phase A, then the word selection
  and the crops gathered on the device from the detector-resolution page
  (``ops/crop_gather.crop_resize_pad_mm``; ``crop_scale=k`` uploads a
  (k·target)² copy of the page to crop from instead, and implies this path),
  then phase B.

``predict_many`` runs the native stages as the JAX package's four-stage
software pipeline (one prep thread, two crop and two finish threads, up to
``queue_depth`` chunks in flight). Where the JAX package overlaps by
asynchronous dispatch, the port splits each device phase into a launch on the
main thread (its kernels enqueued on the current CUDA stream, then a copy of
the results into pinned host memory and an event) and a fetch in a stage
thread (the event's wait), so the host's prep, crops and page builds run
beside the card's work. Short chunks are not padded to ``batch_pages``:
nothing here is compiled for a fixed batch. Each launch is a profiler and
NVTX region (``utils/profiling.annotate``): ``fused.phase_a``,
``fused.phase_b`` and, on the device-crop path, ``fused.page_program``.

Every launch goes through a mesh (``parallel.make_mesh``); without one it
is the 1 × 1 mesh of the detector's device, holding the wrappers' own
models. Every chunk, a single page's too, is padded to a multiple of the
mesh's data axis by repeating its last page, and cut into contiguous slices
of pages, one per data row. The main thread launches each device phase on
every slice, on the slice's device with that device's copy of the models,
before it waits for any; the outputs come back in page order. Under a
process group every process gets the same pages and computes its rank's
slice; the outputs are gathered from all ranks, so every process builds
every page, and the stages of a chunk run one after another on the calling
thread (``start_batch`` then only prepares the pages: the launches and
their collectives stay on the thread that finishes).

The upload is the plain uint8 page: the JAX package's row-delta and
channel-fold transport is a lossless trick for its TPU link and gives the
same bytes on the device. At most ``max_words`` words are recognized per
page; further words keep their boxes and get no text. With
``max_words="auto"`` the first page's eligible-word count, from the count
program (one EAST forward, then decode → NMS → postprocess → count at the
configured ``max_boxes``), picks the capacity bucket and shrinks
``max_boxes``. A denser page later grows the bucket: on the native path
before its phase B, on the device path by running that page again.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from .ops.boxes import quad_bbox_int
from .ops.crop_gather import crop_resize_pad_mm
from .ops.image import crop_axis_aligned, detector_preprocess_host, read_image, resize_and_pad
from .ops.lanms_torch import locality_aware_nms_parallel
from .ops.postprocess_torch import postprocess_boxes
from .ops.reading_order import reading_order_permutation
from .parallel.mesh import (
    DATA_AXIS,
    all_gather_rows,
    broadcast_,
    on_device,
    one_device_mesh,
    rank_rows,
    replicate,
    shard_batch,
)
from .types import Block, Page, Word
from .utils.profiling import annotate
from .utils.visualize import visualize_page


class _Pending:
    """Device results on their way to the host. On the card the copies into
    pinned memory are enqueued on the current stream, followed by an event;
    ``wait`` blocks on that event (it releases the GIL). CPU tensors are
    ready as they are."""

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        if tensors[0].device.type == "cuda":
            self.host = [
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                for t in tensors
            ]
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = list(tensors)

    def wait(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [t.numpy() for t in self.host]


class _Gathered:
    """The results of a phase launched on several slices of a chunk: each
    slice's ``_Pending``; ``wait`` joins them along the page axis."""

    def __init__(self, parts: List[_Pending]):
        self.parts = parts

    def wait(self) -> List[np.ndarray]:
        outs = [p.wait() for p in self.parts]
        return outs[0] if len(outs) == 1 else [np.concatenate(o) for o in zip(*outs)]


class FusedOCR:
    CAPACITY_BUCKETS = (32, 64, 128, 256)  # word slots per page in a phase-B call
    CAPACITY_HEADROOM = 8  # spare slots a bucket keeps (fewer for small ones)
    CALIBRATION_THRESHOLDS = (0.6, 0.7, 0.8, 0.9, 0.95, 0.99, 0.999)
    # input type of the device crop products: bfloat16 is within ±1 uint8
    # level of float32 (ops/crop_gather.py), as the JAX package's default
    CROP_DTYPE = torch.bfloat16

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
        batch_pages: int = 4,
        crop_scale: int = 1,
        crop_source: str = "native",
        mesh=None,
    ):
        """``batch_pages`` pages share one phase-A and one phase-B pass in
        ``predict_many``. ``crop_scale=k`` crops from a (k·target)² copy of
        the page and selects ``crop_source="device"``. ``mesh``
        (``parallel.make_mesh``) shards each chunk's pages over its data
        axis: ``batch_pages`` rounds up to a multiple of the data-axis size,
        and each device of the data axis gets an eval-mode copy of both
        models. The count program of the auto capacity and ``calibrate``
        stay on the detector's own device."""
        if mode not in ("greedy", "beam"):
            raise ValueError(f"Unknown mode: {mode}")
        if max_words != "auto" and not isinstance(max_words, int):
            raise ValueError(f"max_words must be an int or 'auto': {max_words!r}")
        if crop_source not in ("native", "device"):
            raise ValueError(f"Unknown crop_source: {crop_source!r}")
        if not (isinstance(crop_scale, int) and crop_scale >= 1):
            raise ValueError(f"crop_scale must be an int >= 1: {crop_scale!r}")
        self.detector = detector
        self.recognizer = recognizer
        self._auto_capacity = max_words == "auto"
        self.max_words = None if self._auto_capacity else max_words
        self.mode = mode
        self.beam_size = beam_size
        self.alpha = alpha
        self.temperature = temperature
        self.min_text_size = min_text_size
        self.device = detector.device
        if mesh is None:  # the wrappers' own models on their device
            self.mesh = one_device_mesh(self.device)
            self._replicas = [(detector.model, recognizer.model)]
        else:
            self.mesh = mesh
            self._replicas = list(zip(replicate(detector.model, mesh),
                                      replicate(recognizer.model, mesh)))
        n_data = self.mesh.shape[DATA_AXIS]
        self.batch_pages = max(n_data, -(-batch_pages // n_data) * n_data)
        self.crop_scale = crop_scale
        self.crop_source = "device" if crop_scale > 1 else crop_source
        self._orig_max_boxes = detector.max_boxes
        self._capacity_lock = threading.Lock()  # crop stages may overlap
        # start_batch and finish_batch may run on two threads (a server's
        # batcher and finisher): their launches take turns, so that one
        # thread launches at a time and the launch counters stay exact
        self._launch_lock = threading.Lock()
        self._warmed_buckets: set = set()
        self.last_dropped = 0
        self.last_overflow = 0  # words over capacity on the last overflowing page
        self.last_timings: Dict[str, float] = {}  # the last chunk's host-clock stage seconds
        self.chunk_timings: List[Dict[str, float]] = []  # every chunk of the last call

    # ---- device plumbing ---------------------------------------------------

    def _host_buffer(self, shape, fill=None) -> torch.Tensor:
        """A uint8 host tensor, pinned when the pipeline runs on the card so
        that its upload does not block."""
        buf = torch.empty(shape, dtype=torch.uint8, pin_memory=self.device.type == "cuda")
        if fill is not None:
            buf.fill_(fill)
        return buf

    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, non_blocking=True)

    @property
    def _grouped(self) -> bool:
        """A mesh over several processes."""
        return self.mesh.group is not None

    def _launch(self, fn, *host):
        """``fn(detector model, recognizer model, *device tensors)`` → a
        tuple of tensors with a leading page axis, launched on the host
        tensors ``host`` (page axis first; None passes through) and their
        results' copy started: on each slice of the pages this process
        computes, on the slice's device with its models (without a mesh, the
        whole chunk on the pipeline's device with the wrappers' own); under
        a process group the outputs are then gathered from every rank."""
        parts = []
        for (_, dev), (det_model, rec_model), piece in zip(
                self.mesh.local_shards, self._replicas, shard_batch(host, self.mesh)):
            with on_device(dev):
                outs = fn(det_model, rec_model, *piece)
                if self._grouped:
                    outs = [all_gather_rows(o, self.mesh) for o in outs]
                parts.append(_Pending(*outs))
        return _Gathered(parts)

    def _computes_page(self, i: int, b: int) -> bool:
        """Whether this process computes page ``i`` of a chunk of ``b``: every
        page in one process, the rank's slice under a process group."""
        if not self._grouped:
            return True
        rows = rank_rows(b, self.mesh)
        return rows.start <= i < rows.stop

    # ---- phase A -------------------------------------------------------------

    def _detect(self, pages: torch.Tensor, scale_x, scale_y, model=None) -> torch.Tensor:
        """Phase A on (B, target, target, 3) uint8 pages on the device → boxes9
        (B, max_boxes, 9), score −1 on invalid rows; ``scale_x``/``scale_y``
        are (B,) page/target ratios; ``model`` a copy of the detector's model
        (its own by default)."""
        score, geo = self.detector.maps(pages, model)
        return self._boxes(score, geo, self.detector.score_thresh, scale_x, scale_y)

    def _boxes(self, score, geo, score_thresh, scale_x, scale_y) -> torch.Tensor:
        """EAST maps (B, h, w), (B, h, w, 8) → decode → NMS → postprocess →
        boxes9 (B, max_boxes, 9), score −1 on invalid rows. ``score_thresh``
        is one number or one per page."""
        det = self.detector
        cands = det.candidates(score, geo, score_thresh)
        merged, count = locality_aware_nms_parallel(cands, det.iou_threshold, det.max_boxes)
        boxes9, bvalid = postprocess_boxes(
            merged, count, det.expand_ratio_w, det.expand_ratio_h, scale_x, scale_y,
            axis_aligned=det.axis_aligned_output,
            remove_anomalies=det.remove_area_anomalies,
            anomaly_sigma=det.anomaly_sigma_threshold,
            anomaly_min_count=det.anomaly_min_box_count,
        )
        boxes9[..., 8] = torch.where(bvalid, boxes9[..., 8], torch.full_like(boxes9[..., 8], -1.0))
        return boxes9

    def _box_extents(self, boxes9: torch.Tensor):
        """Floor'd axis-aligned extents (x_min, y_min, x_max, y_max) of each
        row and the rows eligible for recognition (valid, both extents ≥
        min_text_size)."""
        bq = boxes9[..., :8].reshape(*boxes9.shape[:-1], 4, 2)
        x_min, x_max = torch.floor(bq[..., 0].amin(-1)), torch.floor(bq[..., 0].amax(-1))
        y_min, y_max = torch.floor(bq[..., 1].amin(-1)), torch.floor(bq[..., 1].amax(-1))
        big = ((x_max - x_min) >= self.min_text_size) & ((y_max - y_min) >= self.min_text_size)
        return (x_min, y_min, x_max, y_max), (boxes9[..., 8] >= 0.0) & big

    # ---- word capacity ---------------------------------------------------------

    @torch.inference_mode()
    def _count_words(self, page, thresholds: Sequence[float], scale_x: float, scale_y: float):
        """The count program: ONE EAST forward on a (target, target, 3) uint8
        page, then decode → NMS → postprocess → eligible count for each
        threshold (the thresholds are the page axis) → int counts."""
        det = self.detector
        n = len(thresholds)
        score, geo = det.maps(torch.as_tensor(page).to(self.device)[None])
        boxes9 = self._boxes(
            score.expand(n, -1, -1), geo.expand(n, -1, -1, -1),
            torch.tensor(thresholds, dtype=torch.float32), scale_x, scale_y,
        )
        counts = self._box_extents(boxes9)[1].sum(dim=1)
        if self._grouped:  # every rank sizes the capacity alike
            broadcast_([counts], self.mesh)
        return counts.cpu().numpy().astype(int)

    def calibrate(
        self,
        image,
        thresholds: Sequence[float] = CALIBRATION_THRESHOLDS,
        target_max_words: int = 250,
    ) -> Tuple[float, Dict[float, int]]:
        """Pick the lowest ``score_thresh`` whose eligible-word count is ≤
        ``target_max_words`` with one count program, set it on the detector
        and, in auto-capacity mode before the capacity is known, size
        ``max_words``/``max_boxes`` from the chosen count. Returns
        ``(chosen_thresh, {thresh: count})``."""
        det = self.detector
        img = read_image(image)
        resized = detector_preprocess_host(img, det.target_size)
        counts = self._count_words(
            resized, tuple(thresholds), img.shape[1] / det.target_size,
            img.shape[0] / det.target_size,
        )
        chosen, chosen_count = float(thresholds[-1]), int(counts[-1])
        for t, n in zip(thresholds, counts):
            if n <= target_max_words:
                chosen, chosen_count = float(t), int(n)
                break
        det.score_thresh = chosen
        if self._auto_capacity and self.max_words is None:
            self._apply_capacity(chosen_count)
        return chosen, {float(t): int(n) for t, n in zip(thresholds, counts)}

    def _resolve_capacity(self, page, scale_x: float, scale_y: float) -> None:
        """Auto capacity, first page: one count program at the current
        threshold sizes the capacity."""
        if self.max_words is None:
            det = self.detector
            self._apply_capacity(
                int(self._count_words(page, (float(det.score_thresh),), scale_x, scale_y)[0])
            )

    def _headroom(self, cap: int) -> int:
        return min(self.CAPACITY_HEADROOM, max(2, cap // 8))

    def _grown_bucket(self, n_words: int, above: int = 0) -> int:
        """Smallest bucket above ``above`` that holds ``n_words`` with its
        headroom, else the largest."""
        return next(
            (c for c in self.CAPACITY_BUCKETS if c > above and n_words <= c - self._headroom(c)),
            self.CAPACITY_BUCKETS[-1],
        )

    def _apply_capacity(self, n_words: int) -> None:
        cap = self._grown_bucket(n_words)
        self.max_words = cap
        # box capacity follows the word capacity (4× headroom, at least 256),
        # never above the detector's configured bound
        self.detector.max_boxes = min(self._orig_max_boxes, max(4 * cap, 256))

    def _native_capacity_for(self, n_eligible: int) -> int:
        with self._capacity_lock:
            nw = self.max_words
            if n_eligible > nw and self._auto_capacity:
                grown = self._grown_bucket(n_eligible, above=nw)
                if grown > nw:
                    self.last_overflow = n_eligible - nw
                    self.max_words = nw = grown
        return nw

    def _chunk_bucket(self, max_elig: int) -> int:
        """Smallest bucket covering the chunk's densest page, capped at the
        (possibly grown) global bound."""
        cap = self._native_capacity_for(max_elig)
        nw = next((c for c in self.CAPACITY_BUCKETS if c >= max_elig), cap)
        return min(nw, cap)

    # ---- chunk stages ----------------------------------------------------------

    def _host_pages(self, imgs: List[np.ndarray], size: int) -> torch.Tensor:
        """(B, size, size, 3) uint8 detector copies of the pages, in one
        (pinned on the card) host buffer."""
        buf = self._host_buffer((len(imgs), size, size, 3))
        out = buf.numpy()
        for i, img in enumerate(imgs):
            out[i] = detector_preprocess_host(img, size)
        return buf

    def _prepare_chunk(self, chunk) -> tuple:
        """Stage 1 (prep thread): read and resize up to ``batch_pages``
        pages into one host buffer (and the ``crop_scale`` copies). With a
        mesh the last page repeats up to a multiple of the data axis;
        ``timings["pages"]`` counts the chunk's own pages."""
        t0 = time.perf_counter()
        det = self.detector
        imgs = [read_image(im) for im in chunk]
        n = len(imgs)
        imgs += imgs[-1:] * ((-n) % self.mesh.shape[DATA_AXIS])
        pages = self._host_pages(imgs, det.target_size)
        hi = self._host_pages(imgs, self.crop_scale * det.target_size) if self.crop_scale > 1 else None
        sx = np.array([img.shape[1] / det.target_size for img in imgs], np.float32)
        sy = np.array([img.shape[0] / det.target_size for img in imgs], np.float32)
        timings = {"pages": n, "prep": time.perf_counter() - t0}
        return imgs, pages, hi, sx, sy, timings

    @torch.inference_mode()
    def _dispatch_detect_prepared(self, prep) -> tuple:
        """Native stage 2 (main thread): resolve the capacity on the first
        page, launch the chunk's phase A and start its boxes' copy."""
        imgs, pages, _hi, sx, sy, timings = prep
        self._resolve_capacity(pages[0], float(sx[0]), float(sy[0]))
        t0 = time.perf_counter()
        with annotate("fused.phase_a"):
            pending = self._launch(lambda det_model, _, p, x, y: (self._detect(p, x, y, det_model),),
                                   pages, torch.from_numpy(sx), torch.from_numpy(sy))
        timings["detect"] = time.perf_counter() - t0
        return imgs, pending, timings

    def _eligible_rows(self, boxes9: np.ndarray) -> np.ndarray:
        """Indices of a page's host rows eligible for recognition."""
        return np.nonzero(self._box_extents(torch.from_numpy(boxes9))[1].numpy())[0]

    def _native_strip(self, out: np.ndarray, img: np.ndarray, boxes9: np.ndarray, rows) -> None:
        """Fill (nw, img_h, img_w, 3) white slots with the rows' native crops
        (unused slots stay white; they are decoded too, and their outputs
        dropped)."""
        rec = self.recognizer
        for s, r in enumerate(rows):
            poly = boxes9[int(r), :8].reshape(4, 2).astype(np.int32)
            region = crop_axis_aligned(img, poly)
            if region is not None and region.size > 0:
                out[s] = resize_and_pad(region, rec.img_h, rec.img_w)

    def _crop_stage(self, imgs, pending: _Pending, timings) -> tuple:
        """Native stage 3 (crop thread): wait for the boxes, select words,
        crop them from the original pages into one host strip."""
        t0 = time.perf_counter()
        (boxes,) = pending.wait()
        rows_all = [self._eligible_rows(b) for b in boxes]
        nw = self._chunk_bucket(max(len(r) for r in rows_all))
        rec = self.recognizer
        strip = self._host_buffer((len(imgs), nw, rec.img_h, rec.img_w, 3), fill=255)
        out = strip.numpy()
        rows_used, dropped = [], 0
        for i, img in enumerate(imgs):
            rows = rows_all[i][:nw]
            dropped = max(dropped, len(rows_all[i]) - len(rows))
            rows_used.append(rows)
            if self._computes_page(i, len(imgs)):
                self._native_strip(out[i], img, boxes[i], rows)
        timings["crops"], timings["slots"] = time.perf_counter() - t0, nw
        return imgs, list(boxes), rows_used, strip, nw, dropped, timings

    @torch.inference_mode()
    def _dispatch_rec_chunk(self, crop_res) -> tuple:
        """Native stage 4 (main thread, in chunk order): publish the drop
        diagnostics, launch phase B on the chunk's strip and start the
        results' copy."""
        imgs, boxes, rows_used, strip, nw, dropped, timings = crop_res
        self.last_dropped = dropped
        if dropped > 0:
            self.last_overflow = dropped
        t0 = time.perf_counter()
        rec = self.recognizer
        with annotate("fused.phase_b"):
            pending = self._launch(lambda _, rec_model, s: rec.recognize_tensor(
                s.reshape(-1, rec.img_h, rec.img_w, 3), self.mode, self.beam_size, self.alpha,
                self.temperature, rec_model,
            ), strip)
        timings["recognize"] = time.perf_counter() - t0
        return imgs, boxes, rows_used, pending, nw, timings

    def _finish_rec_chunk(self, rec_res, vis: bool = False) -> List[Any]:
        """Native stage 5 (finish thread): wait for the texts, build pages
        (with ``vis``, (page, drawn page) pairs)."""
        imgs, boxes, rows_used, pending, nw, timings = rec_res
        t0 = time.perf_counter()
        preds, confs = pending.wait()
        pages = []
        for i in range(timings["pages"]):
            src_idx = np.full(nw, -1, np.int64)
            src_idx[: len(rows_used[i])] = rows_used[i]
            pages.append(self._page_or_vis(imgs[i], self._build_page_result(
                boxes[i], src_idx, preds[i * nw : (i + 1) * nw], confs[i * nw : (i + 1) * nw]
            ), vis))
        timings["finish"] = time.perf_counter() - t0
        return pages

    # ---- the one-program path (device crops) -----------------------------------

    def _page_program(self, pages, pages_hi, scale_x, scale_y, det_model=None,
                      rec_model=None) -> tuple:
        """Phase A, word selection, device crops and phase B for a chunk →
        (boxes9 (B, nb, 9), confs (B, nw), token ids (B, nw, steps), src_idx
        (B, nw) with −1 on unused slots, eligible counts (B,)); the models
        are copies of the wrappers' (their own by default)."""
        rec = self.recognizer
        boxes9 = self._detect(pages, scale_x, scale_y, det_model)
        b, nb = boxes9.shape[:2]
        nw = self.max_words
        dev = boxes9.device
        (x_min, y_min, x_max, y_max), elig = self._box_extents(boxes9)
        csum = torch.cumsum(elig.to(torch.int64), 1)
        sel = elig & (csum <= nw)
        slot = torch.where(sel, csum - 1, nw)
        page = torch.arange(b, device=dev)[:, None] * (nw + 1)
        target = (page + slot).reshape(-1)

        def scatter(vals):  # (B, nb, ...) → (B, nw, ...), 0 on unused slots
            buf = torch.zeros((b * (nw + 1), *vals.shape[2:]), dtype=vals.dtype, device=dev)
            buf[target] = vals.reshape(b * nb, *vals.shape[2:])
            return buf.reshape(b, nw + 1, *vals.shape[2:])[:, :nw]

        src_idx = scatter(torch.arange(nb, device=dev).expand(b, nb))
        # crop boxes back in detector pixels (scaled to the hi-res copy)
        det_boxes = scatter(torch.stack([
            x_min / scale_x[:, None], y_min / scale_y[:, None],
            x_max / scale_x[:, None], y_max / scale_y[:, None],
        ], dim=2))
        wvalid = torch.arange(nw, device=dev)[None, :] < sel.sum(dim=1, keepdim=True)
        src = pages if pages_hi is None else pages_hi
        crops = torch.cat([
            crop_resize_pad_mm(
                src[i], det_boxes[i] * float(self.crop_scale), wvalid[i], rec.img_h,
                rec.img_w, dtype=self.CROP_DTYPE, aspect=(scale_x[i], scale_y[i]),
            )
            for i in range(b)
        ])
        preds, confs = rec.recognize_tensor(
            crops, self.mode, self.beam_size, self.alpha, self.temperature, rec_model
        )
        return (
            boxes9, confs.reshape(b, nw), preds.reshape(b, nw, -1),
            torch.where(wvalid, src_idx, torch.full_like(src_idx, -1)), elig.sum(dim=1),
        )

    @torch.inference_mode()
    def _dispatch_prepared(self, prep) -> tuple:
        """Device-crop path (main thread): launch the chunk's program and
        start its results' copy."""
        imgs, pages, hi, sx, sy, timings = prep
        self._resolve_capacity(pages[0], float(sx[0]), float(sy[0]))
        t0 = time.perf_counter()
        nw = self.max_words
        with annotate("fused.page_program"):
            pending = self._launch(
                lambda det_model, rec_model, p, h, x, y: self._page_program(
                    p, h, x, y, det_model, rec_model),
                pages, hi, torch.from_numpy(sx), torch.from_numpy(sy),
            )
        timings["dispatch"], timings["slots"] = time.perf_counter() - t0, nw
        return imgs, pending, nw, timings

    def _finish_chunk(self, imgs, pending: _Pending, nw: int, timings, vis: bool = False) -> List[Any]:
        """Device-crop path (main thread): wait for the chunk, build its
        pages; a page that overflowed an auto capacity runs again."""
        t0 = time.perf_counter()
        outs = pending.wait()
        pages = [self._finish(img, [o[i] for o in outs], nw, vis)
                 for i, img in enumerate(imgs[:timings["pages"]])]
        timings["finish"] = time.perf_counter() - t0
        return pages

    def _finish(self, img, outs, nw: int, vis: bool = False, retried: bool = False):
        boxes9, confs, preds, src_idx, n_eligible = outs
        # words past the capacity kept their boxes but got no text; in auto
        # mode grow the bucket and run the page again at the grown capacity.
        # As in the JAX package, only while the capacity still grows: a
        # later page of the same chunk that overflowed the old capacity
        # keeps its boxes without texts
        self.last_dropped = max(0, int(n_eligible) - int((src_idx >= 0).sum()))
        if self.last_dropped > 0:
            self.last_overflow = self.last_dropped
            if self._auto_capacity:
                grown = self._grown_bucket(int(n_eligible), above=nw)
                if grown > max(nw, self.max_words):
                    self.max_words = grown
                    if not retried:
                        _, pending, nw2, _ = self._dispatch_prepared(self._prepare_chunk([img]))
                        return self._finish(img, [o[0] for o in pending.wait()], nw2, vis,
                                            retried=True)
        return self._page_or_vis(img, self._build_page_result(boxes9, src_idx, preds, confs), vis)

    @staticmethod
    def _page_or_vis(img: np.ndarray, page: Page, vis: bool):
        """The page, or with ``vis`` (page, the page image drawn with the words
        numbered in reading order)."""
        return (page, visualize_page(img, page, show_order=True)) if vis else page

    # ---- page ----------------------------------------------------------------

    def _build_page_result(self, boxes9, src_idx, preds, confs) -> Page:
        """Words from the valid box rows, texts by the slot → row mapping
        (−1 marks an unused slot), reading order."""
        rec = self.recognizer
        words: List[Word] = []
        row_to_word = {}
        for row in np.nonzero(boxes9[:, 8] >= 0.0)[0]:
            quad = boxes9[row]
            word = Word(
                polygon=quad[:8].reshape(4, 2).tolist(),
                detection_confidence=float(np.clip(quad[8], 0.0, 1.0)),
            )
            row_to_word[int(row)] = word
            words.append(word)
        for s in np.nonzero(src_idx >= 0)[0]:
            word = row_to_word[int(src_idx[s])]
            word.text = rec.decode(preds[s])
            word.recognition_confidence = float(np.clip(confs[s], 0.0, 1.0))
        if words:
            boxes = [quad_bbox_int(np.asarray(w.polygon, dtype=np.int32)) for w in words]
            words = [words[i] for i in reading_order_permutation(boxes)]
        return Page(blocks=[Block(words=words)])

    def recognize(self, crops: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Phase B alone: (nw, img_h, img_w, 3) uint8 → (confs, token ids)."""
        preds, confs = self.recognizer.recognize_u8(
            crops, self.mode, self.beam_size, self.alpha, self.temperature
        )
        return confs, preds

    def _run_chunk(self, prep, vis: bool = False) -> List[Any]:
        """A prepared chunk's stages, one after another on this thread."""
        if self.crop_source == "native":
            rec = self._dispatch_rec_chunk(self._crop_stage(*self._dispatch_detect_prepared(prep)))
            return self._finish_rec_chunk(rec, vis)
        return self._finish_chunk(*self._dispatch_prepared(prep), vis=vis)

    def predict(self, image, vis: bool = False):
        """One page: the chunk stages, one after another, on a chunk of one →
        Page, or (Page, PIL image) with ``vis``. Under a process group every
        rank calls it with the same page."""
        prep = self._prepare_chunk([image])
        page = self._run_chunk(prep, vis)[0]
        self.last_timings = prep[-1]
        self.chunk_timings = [prep[-1]]
        return page

    # ---- many pages ----------------------------------------------------------

    def _chunks(self, images) -> List[list]:
        b = self.batch_pages
        return [list(images[i : i + b]) for i in range(0, len(images), b)]

    def _predict_many_native(self, chunks, queue_depth: int, timings: list, vis: bool) -> List[Any]:
        """The four-stage software pipeline: prep (1 thread) → phase A launch
        (main) → box wait + host crops (2 threads) → phase B launch (main) →
        result wait + page build (2 threads). Chunk i's phase A is launched
        before the main thread waits for chunk i−1's crops, so the two
        overlap on the card; at most ``queue_depth`` finishes stay pending."""
        n = len(chunks)
        results: List[Page] = []
        window = queue_depth + 1
        with ThreadPoolExecutor(max_workers=1) as prep_ex, \
                ThreadPoolExecutor(max_workers=2) as crop_ex, \
                ThreadPoolExecutor(max_workers=2) as fin_ex:
            prep_f, crop_f, fin_f = {}, {}, {}
            next_prep = 0
            for i in range(n):
                while next_prep < min(n, i + window):
                    prep_f[next_prep] = prep_ex.submit(self._prepare_chunk, chunks[next_prep])
                    next_prep += 1
                prep = prep_f.pop(i).result()
                timings.append(prep[-1])
                det_i = self._dispatch_detect_prepared(prep)
                crop_f[i] = crop_ex.submit(self._crop_stage, *det_i)
                if i >= 1:
                    rec = self._dispatch_rec_chunk(crop_f.pop(i - 1).result())
                    fin_f[i - 1] = fin_ex.submit(self._finish_rec_chunk, rec, vis)
                    while len(fin_f) > queue_depth:
                        results.extend(fin_f.pop(min(fin_f)).result())
            rec = self._dispatch_rec_chunk(crop_f.pop(n - 1).result())
            fin_f[n - 1] = fin_ex.submit(self._finish_rec_chunk, rec, vis)
            for i in sorted(fin_f):
                results.extend(fin_f[i].result())
        return results

    def _predict_many_device(self, chunks, queue_depth: int, timings: list, vis: bool) -> List[Any]:
        """Device crops: prep in one thread, up to ``queue_depth`` chunks'
        programs in flight, each finished (and any overflowing page run
        again) on the main thread in order."""
        results: List[Page] = []
        in_flight: List[tuple] = []
        with ThreadPoolExecutor(max_workers=1) as ex:
            preps = [ex.submit(self._prepare_chunk, c) for c in chunks[: queue_depth + 1]]
            nxt = len(preps)
            while preps:
                prep = preps.pop(0).result()
                timings.append(prep[-1])
                in_flight.append(self._dispatch_prepared(prep))
                if nxt < len(chunks):
                    preps.append(ex.submit(self._prepare_chunk, chunks[nxt]))
                    nxt += 1
                if len(in_flight) > queue_depth:
                    results.extend(self._finish_chunk(*in_flight.pop(0), vis=vis))
        for handle in in_flight:
            results.extend(self._finish_chunk(*handle, vis=vis))
        return results

    def predict_many(self, images: List[Any], vis: bool = False, queue_depth: int = 2) -> List[Any]:
        """OCR many pages, ``batch_pages`` per chunk → Pages, or (Page, PIL
        image) pairs with ``vis`` (drawn on the finish threads);
        ``chunk_timings`` then holds each chunk's host-clock stage seconds
        and slot count."""
        chunks = self._chunks(images)
        if not chunks:
            return []
        timings: List[Dict[str, float]] = []
        if self._grouped:  # every rank launches its collectives in the same order
            results = []
            for chunk in chunks:
                prep = self._prepare_chunk(chunk)
                timings.append(prep[-1])
                results.extend(self._run_chunk(prep, vis))
        else:
            run = self._predict_many_native if self.crop_source == "native" else self._predict_many_device
            results = run(chunks, queue_depth, timings, vis)
        self.chunk_timings, self.last_timings = timings, timings[-1]
        return results

    # ---- asynchronous chunks (for a serving layer) -------------------------------

    def start_batch(self, images: List[Any]):
        """Begin a batch: host prep and the first device launch now, the
        rest in ``finish_batch``. One start/finish pair per batch, FIFO; a
        batch larger than ``batch_pages`` is split into chunks. Start and
        finish may be called from two threads: their launches take turns.
        Under a process group start only prepares, and finish launches."""
        if len(images) > self.batch_pages:
            return ("multi", [self.start_batch(c) for c in self._chunks(images)])
        prep = self._prepare_chunk(images)
        if self._grouped:
            return ("prepared", prep)
        with self._launch_lock:
            if self.crop_source == "native":
                return ("native", self._dispatch_detect_prepared(prep))
            return ("device", self._dispatch_prepared(prep))

    def finish_batch(self, handle) -> List[Page]:
        """Complete a ``start_batch`` handle: wait for the device and build
        the pages."""
        kind, payload = handle
        if kind == "multi":
            return [page for sub in payload for page in self.finish_batch(sub)]
        if kind == "prepared":
            with self._launch_lock:
                return self._run_chunk(payload)
        if kind == "native":
            crops = self._crop_stage(*payload)
            with self._launch_lock:
                rec = self._dispatch_rec_chunk(crops)
            return self._finish_rec_chunk(rec)
        with self._launch_lock:  # an overflowing page runs again
            return self._finish_chunk(*payload)

    def warm_next_bucket(self, block: bool = False):
        """Run phase B once on a white strip at the next capacity bucket
        above ``max_words`` (and at any smaller bucket not yet run), for each
        chunk size 1 … ``batch_pages``, so that a page that grows the
        capacity, or a short chunk, does not pay the first pass at a new
        shape (cuDNN's plan choice and the allocator's growth; measured in
        PERF.md) on a request's path. Only the server calls it, between
        batches. The port compiles nothing ahead, and the warm runs on the
        calling thread, taking its turn with the launches of
        ``start_batch``/``finish_batch`` (so ``block`` changes nothing: the
        call always returns when the warm is done). Returns the warmed
        buckets, or None when there is nothing to warm: a pinned capacity
        (it never grows), a capacity not yet known, the device-crop path, or
        every bucket up to the next one warmed already."""
        if not self._auto_capacity or self.max_words is None or self.crop_source != "native":
            return None
        nxt = next((c for c in self.CAPACITY_BUCKETS if c > self.max_words), None)
        targets = [c for c in self.CAPACITY_BUCKETS
                   if (nxt is None or c <= nxt) and c not in self._warmed_buckets]
        if not targets:
            return None
        rec = self.recognizer
        # each copy of the model sees slices of up to batch_pages / data pages
        copies = [(dev, m) for (_, dev), (_, m) in zip(self.mesh.local_shards, self._replicas)]
        per_slice = self.batch_pages // self.mesh.shape[DATA_AXIS]
        with self._launch_lock, torch.inference_mode():
            for nw in targets:
                for dev, model in copies:
                    with on_device(dev):
                        for pages in range(1, per_slice + 1):
                            strip = torch.full((pages * nw, rec.img_h, rec.img_w, 3), 255,
                                               dtype=torch.uint8, device=dev)
                            _Pending(*rec.recognize_tensor(
                                strip, self.mode, self.beam_size, self.alpha, self.temperature,
                                model,
                            )).wait()
                self._warmed_buckets.add(nw)
        return targets
