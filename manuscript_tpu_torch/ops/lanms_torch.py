"""Parallel locality-aware NMS on the device (counterpart of
``manuscript_tpu/ops/lanms_jax.py``: ``_normalize_quad``,
``locality_aware_nms_parallel`` and ``_standard_nms``).

1. Candidates are sorted by x0 (stable; invalid rows last). Each is merged
   into the chain of its PREDECESSOR when their IoU clears the threshold
   (the JAX package's documented delta from the host's running-average
   merge), and each chain becomes one score-weighted average quad.
2. Exact greedy NMS over the merged quads as a fixpoint: a bounding-box upper
   bound on IoU picks the pairs that could suppress, up to 16·M of them are
   clipped exactly, pairs beyond that capacity keep the conservative bound,
   and kept[i] = valid[i] ∧ ¬∃ j<i: kept[j] ∧ IoU[j,i] > t is iterated until
   it stops changing (at most M sweeps; one host sync per sweep).

Both IoU calls go through ``ops.quad_iou.quad_iou_gather``: one launch each
on the card, with int32 pair indices and, for the compacted pairs, the live
count on the device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .quad_iou import quad_iou_gather

_IDX = torch.arange(4)
_ORDERS = torch.cat(
    [(_IDX[None, :] + _IDX[:, None]) % 4, (_IDX[:, None] - _IDX[None, :]) % 4]
)  # 8 cyclic / reflected vertex orders, forward first


_PRED_PAIRS: Dict[Tuple[int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}


def _predecessor_pairs(k: int, dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 indices (1..k-1, 0..k-2) of each candidate and its predecessor,
    made once per (k, device)."""
    pairs = _PRED_PAIRS.get((k, dev))
    if pairs is None:
        idx = torch.arange(k, dtype=torch.int32, device=dev)
        pairs = _PRED_PAIRS[(k, dev)] = (idx[1:], idx[:-1])
    return pairs


def _normalize_quad(ref: torch.Tensor, poly: torch.Tensor) -> torch.Tensor:
    """Best vertex ordering of each ``poly`` (K, 4, 2) against ``ref``
    (K, 4, 2) over the 8 orders (forward orders win ties)."""
    cands = poly[:, _ORDERS.to(poly.device)]  # (K, 8, 4, 2)
    d = ((cands - ref[:, None]) ** 2).sum(dim=(2, 3))
    best = torch.argmin(d, dim=1)
    return cands[torch.arange(poly.shape[0], device=poly.device), best]


def _quad_area(q: torch.Tensor) -> torch.Tensor:
    x, y = q[..., 0], q[..., 1]
    xn, yn = torch.roll(x, -1, dims=-1), torch.roll(y, -1, dims=-1)
    return torch.abs((x * yn - xn * y).sum(dim=-1)) / 2.0


def _standard_nms(out_p, out_s, merged_valid, iou_threshold: float):
    """Exact greedy NMS over (M, 4, 2) quads → ((M, 9) kept rows first,
    score-descending; zeros past the count, count)."""
    m = out_p.shape[0]
    dev = out_p.device
    pair_cap = 16 * m
    ninf = torch.full_like(out_s, -float("inf"))

    nms_key = torch.where(merged_valid, out_s, ninf)
    nms_order = torch.sort(-nms_key, stable=True).indices
    quads = out_p[nms_order]
    valid = merged_valid[nms_order]

    x1, x2 = quads[..., 0].amin(dim=1), quads[..., 0].amax(dim=1)
    y1, y2 = quads[..., 1].amin(dim=1), quads[..., 1].amax(dim=1)
    areas = _quad_area(quads)
    iw = (torch.minimum(x2[:, None], x2[None, :]) - torch.maximum(x1[:, None], x1[None, :])).clamp_min(0.0)
    ih = (torch.minimum(y2[:, None], y2[None, :]) - torch.maximum(y1[:, None], y1[None, :])).clamp_min(0.0)
    amax = torch.maximum(areas[:, None], areas[None, :])
    ub = (iw * ih) / amax.clamp_min(1e-12)

    idx = torch.arange(m, device=dev)
    lower = idx[None, :] < idx[:, None]  # j strictly earlier than i
    cand = (ub > iou_threshold) & lower & valid[:, None] & valid[None, :]

    # compact candidate pairs (row-major), clip exactly only those
    flat = cand.reshape(-1)
    slot = torch.cumsum(flat.to(torch.int64), 0) - 1
    within = flat & (slot < pair_cap)
    pair_idx = torch.zeros(pair_cap + 1, dtype=torch.int32, device=dev)
    pair_idx[torch.where(within, slot, pair_cap)] = torch.arange(
        m * m, dtype=torch.int32, device=dev
    )
    pair_idx = pair_idx[:pair_cap]
    n_live = within.sum(dtype=torch.int32)
    live_pair = torch.arange(pair_cap, device=dev) < n_live
    exact = quad_iou_gather(quads, pair_idx // m, pair_idx % m, n_live)
    supp_pair = live_pair & (exact > iou_threshold)

    suppressor = torch.zeros(m * m + 1, dtype=torch.bool, device=dev)
    suppressor[torch.where(live_pair, pair_idx, m * m)] = supp_pair
    suppressor = suppressor[:-1].reshape(m, m)
    # overflow pairs keep the conservative upper-bound decision
    suppressor |= cand & (slot.reshape(m, m) >= pair_cap)

    kept = valid
    for _ in range(m):
        new = valid & ~(suppressor & kept[None, :]).any(dim=1)
        changed = bool((new != kept).any())
        kept = new
        if not changed:
            break

    target = torch.where(kept, torch.cumsum(kept.to(torch.int64), 0) - 1, m)
    rows = torch.cat([quads.reshape(m, 8), out_s[nms_order, None]], dim=1)
    out = torch.zeros(m + 1, 9, dtype=out_p.dtype, device=dev)
    out[target] = rows
    return out[:m], kept.sum()


def locality_aware_nms_parallel(
    cands: torch.Tensor, iou_threshold: float, max_out: int = 1024
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cands (K, 9) rows [x0..y3, score], score < 0 = padding →
    (boxes (max_out, 9) score-descending, zeros past count; count)."""
    k = cands.shape[0]
    dev = cands.device
    scores = cands[:, 8]
    valid = scores >= 0.0

    sort_key = torch.where(valid, cands[:, 0], torch.full_like(scores, float("inf")))
    order = torch.sort(sort_key, stable=True).indices
    quads = cands[:, :8].reshape(k, 4, 2)[order]
    val = valid[order]
    sc = torch.where(val, scores[order], torch.zeros_like(scores))

    prev = torch.cat([quads[:1], quads[:-1]], dim=0)
    aligned = _normalize_quad(prev, quads)

    iou_prev = quad_iou_gather(quads, *_predecessor_pairs(k, dev))
    same = val[1:] & val[:-1] & (iou_prev > iou_threshold)
    brk = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ~same])
    seg = torch.cumsum(brk.to(torch.int64), 0) - 1
    seg = torch.where(val, seg, k)  # invalid rows → dump segment

    vert_sum = torch.zeros(k + 1, 8, dtype=cands.dtype, device=dev).index_add_(
        0, seg, aligned.reshape(k, 8) * sc[:, None]
    )[:k]
    w_sum = torch.zeros(k + 1, dtype=cands.dtype, device=dev).index_add_(0, seg, sc)[:k]
    s_max = torch.full((k + 1,), -float("inf"), dtype=cands.dtype, device=dev).scatter_reduce_(
        0, seg, torch.where(val, sc, torch.full_like(sc, -float("inf"))), "amax"
    )[:k]
    seg_valid = w_sum > 0
    merged = vert_sum / w_sum.clamp_min(1e-12)[:, None]

    # compact valid segments (x-sorted order) into the (max_out,) buffer
    pos = torch.cumsum(seg_valid.to(torch.int64), 0) - 1
    target = torch.where(seg_valid & (pos < max_out), pos, max_out)
    out_p = torch.zeros(max_out + 1, 8, dtype=cands.dtype, device=dev)
    out_p[target] = merged
    out_p = out_p[:max_out].reshape(max_out, 4, 2)
    out_s = torch.full((max_out + 1,), -float("inf"), dtype=cands.dtype, device=dev)
    out_s[target] = torch.where(seg_valid, s_max, torch.full_like(s_max, -float("inf")))
    out_s = out_s[:max_out]
    n = torch.clamp(seg_valid.sum(), max=max_out)
    merged_valid = torch.arange(max_out, device=dev) < n
    return _standard_nms(out_p, out_s, merged_valid, iou_threshold)
