"""Recognition metrics for training (counterpart of
``manuscript_tpu/train/metrics.py``): CER, WER, exact accuracy and their
aggregate, on the edit distance of ``utils/metrics.py``, which also holds
the detection F1 (``compute_f1``, re-exported here).

CER is the edit distance over len(ref), infinite for an empty reference with
a non-empty hypothesis (and left out of the mean); WER the same over words.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..utils.metrics import _edit_distance, _levenshtein_generic, compute_f1, poly_iou

__all__ = ["aggregate_text_metrics", "character_error_rate", "compute_accuracy",
           "compute_f1", "compute_f1_metrics", "poly_iou", "word_error_rate"]


def character_error_rate(ref: str, hyp: str) -> float:
    if len(ref) == 0:
        return 0.0 if len(hyp) == 0 else float("inf")
    return _edit_distance(ref, hyp) / len(ref)


def word_error_rate(ref: str, hyp: str) -> float:
    ref_words, hyp_words = ref.split(), hyp.split()
    if len(ref_words) == 0:
        return 0.0 if len(hyp_words) == 0 else float("inf")
    return _levenshtein_generic(ref_words, hyp_words) / len(ref_words)


def compute_accuracy(refs: Sequence[str], hyps: Sequence[str]) -> float:
    if not refs:
        return 0.0
    return float(np.mean([r == h for r, h in zip(refs, hyps)]))


def aggregate_text_metrics(refs: Sequence[str], hyps: Sequence[str]) -> Dict[str, float]:
    cers = [c for c in (character_error_rate(r, h) for r, h in zip(refs, hyps)) if np.isfinite(c)]
    wers = [w for w in (word_error_rate(r, h) for r, h in zip(refs, hyps)) if np.isfinite(w)]
    return {
        "accuracy": compute_accuracy(refs, hyps),
        "cer": float(np.mean(cers)) if cers else 0.0,
        "wer": float(np.mean(wers)) if wers else 0.0,
    }


def compute_f1_metrics(
    preds: List[Dict],
    gt_segs: Dict,
    processed_ids: Sequence,
    avg_range=(0.50, 0.95),
    avg_step: float = 0.05,
) -> Dict[str, float]:
    """F1@0.5 and the mean F1 over the IoU range (COCO-style 0.5:0.95)."""
    f1_05 = compute_f1(preds, 0.5, gt_segs, processed_ids)
    ious = np.arange(avg_range[0], avg_range[1] + 1e-9, avg_step)
    f1s = [compute_f1(preds, float(t), gt_segs, processed_ids) for t in ious]
    return {"f1@0.5": f1_05, "f1@0.5:0.95": float(np.mean(f1s))}
