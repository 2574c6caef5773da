"""Data contract for OCR results, as plain dataclasses.

Same field names and defaults as ``manuscript_tpu/types.py``: a ``Word``
carries a polygon and a detection confidence and, after recognition, ``text``
and ``recognition_confidence``; a ``Block`` groups words; a ``Page`` groups
blocks. The confidence ranges are checked on construction.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


def _check_unit(name: str, value: Optional[float]) -> None:
    if value is not None and not 0.0 <= value <= 1.0:
        raise ValueError(f"{name} must lie in [0, 1], got {value}")


@dataclass
class Word:
    polygon: List[Tuple[float, float]]
    detection_confidence: float
    text: Optional[str] = None
    recognition_confidence: Optional[float] = None

    def __post_init__(self):
        _check_unit("detection_confidence", self.detection_confidence)
        _check_unit("recognition_confidence", self.recognition_confidence)


@dataclass
class Block:
    """A group of words forming one text block."""

    words: List[Word] = field(default_factory=list)


@dataclass
class Page:
    """A document page: one or more text blocks."""

    blocks: List[Block] = field(default_factory=list)
