"""Data contract for OCR results, as plain dataclasses.

Same field names and defaults as ``manuscript_tpu/types.py``: a ``Word``
carries a polygon and a detection confidence and, after recognition, ``text``
and ``recognition_confidence``; a ``Block`` groups words; a ``Page`` groups
blocks. The confidence ranges are checked on construction, and
``model_dump()`` gives the JAX package's pydantic dicts.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


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

    def model_dump(self) -> Dict[str, Any]:
        """The dict pydantic's ``model_dump`` gives for the JAX package's
        ``Word``: vertices as (x, y) float tuples, confidences as floats."""
        rc = self.recognition_confidence
        return {
            "polygon": [(float(x), float(y)) for x, y in self.polygon],
            "detection_confidence": float(self.detection_confidence),
            "text": self.text,
            "recognition_confidence": None if rc is None else float(rc),
        }


@dataclass
class Block:
    """A group of words forming one text block."""

    words: List[Word] = field(default_factory=list)

    def model_dump(self) -> Dict[str, Any]:
        return {"words": [w.model_dump() for w in self.words]}


@dataclass
class Page:
    """A document page: one or more text blocks."""

    blocks: List[Block] = field(default_factory=list)

    def model_dump(self) -> Dict[str, Any]:
        """Plain dicts and lists, as the JAX package's ``Page.model_dump()``
        (the server's and the CLI's JSON)."""
        return {"blocks": [b.model_dump() for b in self.blocks]}
