"""End-to-end page OCR (counterpart of ``manuscript_tpu/pipeline.py`` on its
fused route, ``FusedOCR``: native crops by default, device crops with
``crop_source="device"`` or ``crop_scale`` > 1).

``Pipeline(device=None)`` runs on the card and raises when there is none;
only ``device="cpu"`` runs on the CPU.
"""

from __future__ import annotations

from typing import Any, List, Optional, Union

import torch

from .fused import FusedOCR
from .types import Page
from .utils.device import resolve_device


class Pipeline:
    def __init__(
        self,
        detector=None,
        recognizer=None,
        device: Optional[Union[str, torch.device]] = None,
        min_text_size: int = 5,
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
        ``device`` (which need weights); given ones must live on ``device``.
        ``max_words`` caps recognized words per page (an int, or "auto" to
        size the capacity from the first page). ``batch_pages`` pages share
        each device pass of ``process_batch``. ``crop_source`` is "native"
        (crops from the full-resolution page on the host) or "device" (crops
        gathered on the device from the detector's copy); ``crop_scale=k``
        crops from a (k·target)² copy on the device instead."""
        self.device = resolve_device(device)
        if detector is None:
            from .detectors import EAST

            detector = EAST(device=self.device)
        if recognizer is None:
            from .recognizers import TRBA

            recognizer = TRBA(device=self.device)
        for part in (detector, recognizer):
            if part.device.type != self.device.type:
                raise ValueError(
                    f"{type(part).__name__} is on {part.device}, the pipeline on {self.device}"
                )
        self.detector = detector
        self.recognizer = recognizer
        self._fused = FusedOCR(
            detector, recognizer, max_words=max_words, mode=mode,
            beam_size=beam_size, alpha=alpha, temperature=temperature,
            min_text_size=min_text_size, batch_pages=batch_pages,
            crop_scale=crop_scale, crop_source=crop_source,
        )
        self.batch_pages = self._fused.batch_pages

    def predict(self, image) -> Page:
        """One page (a path or an RGB uint8 array) → Page."""
        return self._fused.predict(image)

    def process_batch(self, images: List) -> List[Page]:
        """Many pages → one Page each, ``batch_pages`` pages per device pass
        through ``FusedOCR.predict_many``."""
        return self._fused.predict_many(images)

    def start_batch(self, images: List) -> Any:
        """Begin ``process_batch`` on these pages: host prep and the first
        device launch now; returns a handle for :meth:`finish_batch`."""
        return self._fused.start_batch(images)

    def finish_batch(self, handle) -> List[Page]:
        """The pages of a ``start_batch`` handle (handles finish FIFO)."""
        return self._fused.finish_batch(handle)

    @staticmethod
    def get_text(page: Page) -> str:
        """Join recognized words per block (x-sorted), blocks on new lines."""
        lines = []
        for block in page.blocks:
            words = sorted(block.words, key=lambda w: min(p[0] for p in w.polygon))
            texts = [w.text for w in words if w.text]
            if texts:
                lines.append(" ".join(texts))
        return "\n".join(lines)
