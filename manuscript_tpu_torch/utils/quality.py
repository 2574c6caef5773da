"""Quality with trained weights (counterpart of
``manuscript_tpu/utils/quality.py``): the committed synthetic-trained micro
checkpoints of the JAX package (``manuscript_tpu/configs/quality/``, read as
data) score the port's ``Pipeline.process_batch`` (or, ``use_fused=False``,
the classic ``Pipeline.predict``) on held-out synthetic pages with

* detector F1 at IoU 0.5 (``utils.metrics.compute_f1``), and
* end-to-end corpus CER: ground-truth words matched greedily to predictions
  by axis-aligned IoU; an unmatched word counts as a full deletion.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

QUALITY_DIR = Path(__file__).resolve().parents[2] / "manuscript_tpu" / "configs" / "quality"
# the JAX package's numbers for the micro checkpoints (evaluate_quality on
# the CPU), which the card's runs are held to
QUALITY_REFERENCE = Path(__file__).resolve().parent.parent / "configs" / "quality_reference.json"


def quality_reference() -> Dict:
    """``configs/quality_reference.json``: "args" of ``evaluate_quality`` and
    the JAX package's results under "native", "device", "crop_scale_2" and
    "classic"."""
    return json.loads(QUALITY_REFERENCE.read_text())


QUALITY_FILES = ("east_micro.json", "east_micro.msgpack", "trba_micro.msgpack")


def quality_ckpts_available(directory: Union[str, Path] = QUALITY_DIR) -> bool:
    """Whether ``directory`` holds both micro checkpoints and the detector's
    ``east_micro.json``: the committed ones are data of a checkout, which an
    installed package does not ship."""
    return all((Path(directory) / name).exists() for name in QUALITY_FILES)


def load_quality_models(
    device: Optional[Union[str, torch.device]] = None, dtype: torch.dtype = torch.float32,
    directory: Union[str, Path] = QUALITY_DIR,
):
    """EAST + TRBA from the micro checkpoints in ``directory`` (the committed
    ones by default; ``examples/torch_port/make_quality_ckpt.py`` writes
    others) on ``device`` (the card by default). ``east_micro.json`` holds
    the detector's training settings; the TRBA checkpoint carries its own
    charset and config. Raises ``FileNotFoundError`` naming a missing
    file's full path."""
    from ..detectors import EAST
    from ..recognizers import TRBA

    directory = Path(directory).resolve()
    for name in QUALITY_FILES:
        if not (directory / name).exists():
            raise FileNotFoundError(
                f"quality checkpoint {directory / name} is missing: the micro checkpoints live "
                "in a checkout of the repository under manuscript_tpu/configs/quality/; pass "
                "that directory (or one that make_quality_ckpt.py wrote) as directory="
            )
    meta = json.loads((directory / "east_micro.json").read_text())
    east = EAST(
        directory / "east_micro.msgpack",
        device=device,
        backbone=meta["backbone"],
        target_size=meta["target_size"],
        score_thresh=meta["score_thresh"],
        # 0.52 inverts the 0.3 label shrink the checkpoint was trained with
        # (the constructor's default 0.9 is the reference's)
        expand_ratio_w=meta.get("expand_ratio", 0.52),
        expand_ratio_h=meta.get("expand_ratio", 0.52),
        # q=1: each candidate carries its own pixel's score and geometry
        quantization=meta.get("quantization", 1),
        max_candidates=2048,
        max_boxes=256,
        dtype=dtype,
    )
    return east, TRBA(directory / "trba_micro.msgpack", device=device)


def _axis_iou(a: np.ndarray, b: np.ndarray) -> float:
    ax1, ay1 = a[:, 0].min(), a[:, 1].min()
    ax2, ay2 = a[:, 0].max(), a[:, 1].max()
    bx1, by1 = b[:, 0].min(), b[:, 1].min()
    bx2, by2 = b[:, 0].max(), b[:, 1].max()
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    return float(inter / union) if union > 0 else 0.0


def score_pages(pred_pages, gt_pages: List[List[Dict]], iou_thresh: float = 0.5) -> Dict[str, float]:
    """Detector F1, matched-word CER and end-to-end corpus CER over pages.
    ``pred_pages``: Pages; ``gt_pages``: [{"quad", "text"}, ...] per page."""
    from .metrics import _edit_distance, compute_f1

    preds_f1, gt_segs, img_ids = [], {}, []
    total_edit = total_ref = 0
    matched_edit = matched_ref = 0
    n_matched = exact = 0
    for i, (page, gt_words) in enumerate(zip(pred_pages, gt_pages)):
        img_ids.append(i)
        pwords = [w for b in page.blocks for w in b.words]
        preds_f1.extend(
            {"image_id": i, "segmentation": np.asarray(w.polygon, np.float32).ravel()}
            for w in pwords
        )
        gt_segs[i] = [w["quad"].ravel() for w in gt_words]

        used = set()
        for gw in gt_words:
            ref = gw["text"]
            best, best_iou = None, 0.0
            for j, pw in enumerate(pwords):
                if j in used:
                    continue
                iou = _axis_iou(gw["quad"], np.asarray(pw.polygon, np.float32))
                if iou > best_iou:
                    best, best_iou = j, iou
            total_ref += len(ref)
            if best is not None and best_iou >= iou_thresh:
                used.add(best)
                hyp = pwords[best].text or ""
                d = _edit_distance(ref, hyp)
                total_edit += d
                matched_edit += d
                matched_ref += len(ref)
                n_matched += 1
                exact += int(hyp == ref)
            else:
                total_edit += len(ref)  # missed word = full deletion

    f1 = compute_f1(preds_f1, iou_thresh, gt_segs, img_ids)
    n_gt = sum(len(g) for g in gt_pages)
    return {
        "detector_f1": float(f1),
        "e2e_cer": total_edit / max(total_ref, 1),
        "matched_cer": matched_edit / max(matched_ref, 1),
        "word_acc": exact / max(n_gt, 1),
        "match_rate": n_matched / max(n_gt, 1),
        "n_gt_words": n_gt,
    }


def evaluate_quality(
    n_pages: int = 8,
    seed: int = 9000,
    mode: str = "greedy",
    crop_scale: int = 1,
    crop_source: str = "native",
    use_fused: bool = True,
    models: Optional[Tuple] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, float]:
    """End-to-end quality of the micro models on held-out pages through
    ``Pipeline.process_batch`` (``max_words=64``), or with ``use_fused=False``
    through the classic path, ``Pipeline(fused=False).predict`` page by page
    (full-resolution host crops of the host LANMS's boxes). ``models`` are an
    (EAST, TRBA) pair (default: ``load_quality_models(device)``)."""
    from ..pipeline import Pipeline
    from .synthetic import eval_pages

    east, trba = models if models is not None else load_quality_models(device)
    pages = eval_pages(n_pages, seed=seed)
    pipe = Pipeline(
        detector=east, recognizer=trba, device=east.device, fused=use_fused, mode=mode,
        max_words=64, crop_scale=crop_scale, crop_source=crop_source,
    )
    if use_fused:
        pred = pipe.process_batch([p for p, _ in pages])
    else:
        pred = [pipe.predict(p) for p, _ in pages]
    return score_pages(pred, [gt for _, gt in pages])
