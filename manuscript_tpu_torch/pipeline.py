"""End-to-end page OCR (counterpart of ``manuscript_tpu/pipeline.py`` on its
default route, ``FusedOCR`` with native crops).

``Pipeline(device=None)`` runs on the card and raises when there is none;
only ``device="cpu"`` runs on the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Union

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
    ):
        """``detector``/``recognizer`` default to ``EAST()``/``TRBA()`` on
        ``device`` (which need weights); given ones must live on ``device``.
        ``max_words`` caps recognized words per page (an int, or "auto" to
        size the capacity from the first page)."""
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
            min_text_size=min_text_size,
        )

    def predict(self, image) -> Page:
        """One page (a path or an RGB uint8 array) → Page."""
        return self._fused.predict(image)

    def process_batch(self, images: List) -> List[Page]:
        """Pages one after another → one Page each."""
        return [self.predict(im) for im in images]

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
