"""End-to-end page OCR (counterpart of ``manuscript_tpu/pipeline.py``).

Two routes, as in the JAX package:

* the fused route, ``FusedOCR`` (native crops by default, device crops with
  ``crop_source="device"`` or ``crop_scale`` > 1), taken when both parts are
  the port's own EAST and TRBA wrappers and ``fused`` is "auto" or True;
* the classic host loop, taken with ``fused=False`` or duck-typed parts:
  ``detector.predict(image, vis=False, profile=...)`` returns a dict with
  ``"page"``, a tuple whose first element is a Page, or a bare Page; each
  block's words are put in reading order, cropped axis-aligned from the
  full-resolution page, and ``recognizer.predict(list_of_crops)`` returns
  dicts with ``text``/``confidence``, ``(text, confidence)`` tuples or bare
  values. ``process_batch`` uses ``detector.predict_batch`` when there is one
  and recognizes every page's crops in one call.

``vis=True`` makes each result a ``(page, image)`` pair, the image drawn by
``utils/visualize.visualize_page`` (PIL) with the words numbered in reading
order, or without numbers for ``predict(recognize_text=False)``, as the JAX
package draws them.

``Pipeline(device=None)`` runs on the card and raises when there is none;
only ``device="cpu"`` runs on the CPU.
"""

from __future__ import annotations

import inspect
import time
from typing import Any, List, Optional, Union

import numpy as np
import torch

from .fused import FusedOCR
from .ops.boxes import quad_bbox_int
from .ops.image import crop_axis_aligned, read_image
from .ops.reading_order import reading_order_permutation
from .types import Page
from .utils.device import resolve_device
from .utils.visualize import visualize_page


def _page_of(det_out):
    """The Page of a detector's result: a dict's "page", a tuple's first
    element, or the result itself."""
    if isinstance(det_out, dict):
        return det_out.get("page")
    if isinstance(det_out, tuple):
        return det_out[0]
    return det_out


def _vis_source(image, image_array: np.ndarray):
    """What a page is drawn on: the caller's PIL image, else its array."""
    return image if hasattr(image, "convert") else image_array


def _attach(word, result) -> None:
    """A recognizer's result (dict, (text, confidence) or bare value) onto
    its word."""
    if isinstance(result, dict):
        word.text, word.recognition_confidence = result.get("text", ""), result.get("confidence")
    elif isinstance(result, tuple) and len(result) == 2:
        word.text, word.recognition_confidence = result
    else:
        word.text, word.recognition_confidence = ("" if result is None else str(result)), None


class Pipeline:
    def __init__(
        self,
        detector=None,
        recognizer=None,
        device: Optional[Union[str, torch.device]] = None,
        min_text_size: int = 5,
        fused: object = "auto",
        mode: str = "beam",
        beam_size: int = 8,
        alpha: float = 0.9,
        temperature: float = 1.7,
        max_words: Union[int, str] = "auto",
        batch_pages: int = 4,
        crop_scale: int = 1,
        crop_source: str = "native",
    ):
        """``detector``/``recognizer`` default to ``EAST()``/``TRBA()`` on
        ``device`` (which need weights); given ones that carry a ``device``
        must live on ``device``. ``fused``: "auto" takes the fused route when
        both parts are the port's EAST and TRBA wrappers and the classic host
        loop otherwise; True requires the fused route; False takes the
        classic loop. ``mode``/``beam_size``/``alpha``/``temperature`` set
        the decode of both routes (the classic one passes them on to a
        recognizer whose ``predict`` takes them). ``max_words`` caps
        recognized words per page on the fused route (an int, or "auto" to
        size the capacity from the first page). ``batch_pages`` pages share
        each device pass of the fused ``process_batch``. ``crop_source`` is
        "native" (crops from the full-resolution page on the host) or
        "device" (crops gathered on the device from the detector's copy);
        ``crop_scale=k`` crops from a (k·target)² copy on the device
        instead."""
        self.device = resolve_device(device)
        if detector is None:
            from .detectors import EAST

            detector = EAST(device=self.device)
        if recognizer is None:
            from .recognizers import TRBA

            recognizer = TRBA(device=self.device)
        for part in (detector, recognizer):
            dev = getattr(part, "device", None)
            if isinstance(dev, torch.device) and dev.type != self.device.type:
                raise ValueError(
                    f"{type(part).__name__} is on {dev}, the pipeline on {self.device}"
                )
        self.detector = detector
        self.recognizer = recognizer
        self.min_text_size = min_text_size
        self._decode_kwargs = dict(mode=mode, beam_size=beam_size, alpha=alpha, temperature=temperature)
        self._recognizer_accepts_kwargs: Optional[bool] = None

        self._fused = None
        if fused is True or fused == "auto":
            if self._fusable(detector, recognizer):
                self._fused = FusedOCR(
                    detector, recognizer, max_words=max_words, mode=mode,
                    beam_size=beam_size, alpha=alpha, temperature=temperature,
                    min_text_size=min_text_size, batch_pages=batch_pages,
                    crop_scale=crop_scale, crop_source=crop_source,
                )
            elif fused is True:
                raise ValueError(
                    "fused=True needs the port's EAST + TRBA components "
                    "(duck-typed detector/recognizer can't be fused)."
                )
        # the chunk size a serving layer should coalesce to
        self.batch_pages = self._fused.batch_pages if self._fused is not None else batch_pages

    @staticmethod
    def _fusable(detector, recognizer) -> bool:
        return all(
            hasattr(detector, a) for a in ("model", "maps", "max_boxes", "max_candidates")
        ) and all(hasattr(recognizer, a) for a in ("model", "recognize_tensor", "itos"))

    def _call_recognizer(self, word_images):
        """Recognize crops with the pipeline's decode settings when the
        recognizer's ``predict`` takes them (the signature is inspected once,
        not probed with a try, so that a TypeError inside the recognizer is
        not hidden); a bare ``predict(images)`` gets the crops alone."""
        if self._recognizer_accepts_kwargs is None:
            try:
                params = inspect.signature(self.recognizer.predict).parameters
                self._recognizer_accepts_kwargs = any(
                    p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()
                ) or all(k in params for k in self._decode_kwargs)
            except (TypeError, ValueError):  # builtins and C callables
                self._recognizer_accepts_kwargs = False
        if self._recognizer_accepts_kwargs:
            return self.recognizer.predict(word_images, **self._decode_kwargs)
        return self.recognizer.predict(word_images)

    def _crops(self, image_array: np.ndarray, page, all_words: list, word_images: list) -> None:
        """Each block's words into reading order; the crops of the words of
        at least ``min_text_size`` px each way, and those words, appended."""
        for block in page.blocks:
            boxes = [quad_bbox_int(np.asarray(w.polygon, dtype=np.int32)) for w in block.words]
            block.words = [block.words[i] for i in reading_order_permutation(boxes)]
            for word in block.words:
                poly = np.asarray(word.polygon, dtype=np.int32)
                x_min, y_min, x_max, y_max = quad_bbox_int(poly)
                if x_max - x_min >= self.min_text_size and y_max - y_min >= self.min_text_size:
                    region = crop_axis_aligned(image_array, poly)
                    if region is not None and region.size > 0:
                        all_words.append(word)
                        word_images.append(region)

    def predict(self, image, recognize_text: bool = True, vis: bool = False, profile: bool = False):
        """One page (a path, an RGB uint8 array or a PIL image) → Page, or
        (Page, PIL image) with ``vis``."""
        if self._fused is not None and recognize_text:
            result = self._fused.predict(image, vis=vis)
            if profile:
                print(f"Fused stages: {self._fused.last_timings}")
            return result

        start = time.perf_counter()
        page = _page_of(self.detector.predict(image, vis=False, profile=profile))
        if page is None:
            raise RuntimeError("Detector did not return a Page result.")
        if profile:
            print(f"Detection: {time.perf_counter() - start:.3f}s")
        if not recognize_text:
            if vis:
                return page, visualize_page(_vis_source(image, read_image(image)), page, show_order=False)
            return page

        t0 = time.perf_counter()
        image_array = read_image(image)
        all_words, word_images = [], []
        self._crops(image_array, page, all_words, word_images)
        if profile:
            print(f"Extract {len(word_images)} crops: {time.perf_counter() - t0:.3f}s")
        if word_images:
            t0 = time.perf_counter()
            for word, result in zip(all_words, self._call_recognizer(word_images)):
                _attach(word, result)
            if profile:
                print(f"Recognition: {time.perf_counter() - t0:.3f}s")
        if profile:
            print(f"Pipeline total: {time.perf_counter() - start:.3f}s")
        if vis:
            return page, visualize_page(_vis_source(image, image_array), page, show_order=True)
        return page

    def process_batch(
        self,
        images: List,
        recognize_text: bool = True,
        vis: bool = False,
        profile: bool = False,
        detector_batch_size: int = 1,
    ) -> List[Page]:
        """Many pages → one Page each. Fused: ``batch_pages`` pages per device
        pass through ``FusedOCR.predict_many``. Classic: the detector's
        ``predict_batch`` (``detector_batch_size`` pages per device pass)
        when it has one, else ``predict`` page by page; then every page's
        crops in one recognizer call. With ``vis`` each page comes as a
        (Page, PIL image) pair."""
        if self._fused is not None and recognize_text:
            pages = self._fused.predict_many(images, vis=vis)
            if profile:
                print(f"Fused stages per chunk: {self._fused.chunk_timings}")
            return pages
        if not hasattr(self.detector, "predict_batch"):
            return [self.predict(img, recognize_text=recognize_text, vis=vis, profile=profile)
                    for img in images]

        t_start = time.perf_counter()
        arrays = [read_image(im) for im in images]
        pages = [
            _page_of(r)
            for r in self.detector.predict_batch(arrays, batch_size=detector_batch_size, profile=profile)
        ]
        if profile:
            print(f"Batch detection ({len(images)} pages): {time.perf_counter() - t_start:.3f}s")
        if recognize_text:
            t0 = time.perf_counter()
            all_words, word_images = [], []
            for img_arr, page in zip(arrays, pages):
                self._crops(img_arr, page, all_words, word_images)
            if word_images:
                for word, result in zip(all_words, self._call_recognizer(word_images)):
                    _attach(word, result)
            if profile:
                print(f"Batch recognition ({len(word_images)} crops): {time.perf_counter() - t0:.3f}s")
        if vis:
            return [(page, visualize_page(arr, page, show_order=True)) for arr, page in zip(arrays, pages)]
        return pages

    def start_batch(self, images: List) -> Any:
        """Begin ``process_batch`` on these pages: on the fused route host prep
        and the first device launch now; the classic route has no early
        stage and its handle carries the images. Returns a handle for
        :meth:`finish_batch`."""
        if self._fused is not None:
            return ("fused", self._fused.start_batch(images))
        return ("classic", images)

    def finish_batch(self, handle) -> List[Page]:
        """The pages of a ``start_batch`` handle (handles finish FIFO)."""
        kind, payload = handle
        if kind == "fused":
            return self._fused.finish_batch(payload)
        return self.process_batch(payload)

    @staticmethod
    def get_text(page: Page) -> str:
        """Join recognized words per block (x-sorted), blocks on new lines."""
        lines = []
        for block in page.blocks:
            words = sorted(block.words, key=lambda w: min(p[0] for p in w.polygon))
            texts = [w.text for w in words if getattr(w, "text", None)]
            if texts:
                lines.append(" ".join(texts))
        return "\n".join(lines)
