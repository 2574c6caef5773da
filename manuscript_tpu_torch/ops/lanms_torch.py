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

Both functions take an optional leading page axis (the JAX package's
``vmap``): every page keeps its own candidate order, segments, 16·M pair
slots and fixpoint, and the sweeps go on until no page changes. Both IoU
calls go through ``ops.quad_iou.quad_iou_gather``: one launch each for the
whole chunk on the card, with int32 pair indices offset by each page's
start and, for the compacted pairs, one live count per page on the device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .quad_iou import quad_iou_gather

_IDX = torch.arange(4)
_ORDERS = torch.cat(
    [(_IDX[None, :] + _IDX[:, None]) % 4, (_IDX[:, None] - _IDX[None, :]) % 4]
)  # 8 cyclic / reflected vertex orders, forward first


_PRED_PAIRS: Dict[Tuple[int, int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}


def _predecessor_pairs(b: int, k: int, dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 indices into B pages of k candidates: each candidate 1..k-1 of a
    page and its predecessor, made once per (B, k, device)."""
    pairs = _PRED_PAIRS.get((b, k, dev))
    if pairs is None:
        idx = torch.arange(b * k, dtype=torch.int32, device=dev).reshape(b, k)
        pairs = _PRED_PAIRS[(b, k, dev)] = (
            idx[:, 1:].reshape(-1).contiguous(), idx[:, :-1].reshape(-1).contiguous()
        )
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


def _scatter_rows(values: torch.Tensor, target: torch.Tensor, n: int, fill) -> torch.Tensor:
    """Per page, values[b, i] into slot target[b, i] of an (n + 1)-slot
    buffer (slot n is the dump) → (B, n, ...)."""
    b = values.shape[0]
    tail = values.shape[2:]
    out = torch.full((b * (n + 1), *tail), fill, dtype=values.dtype, device=values.device)
    page = torch.arange(b, device=values.device)[:, None] * (n + 1)
    out[(page + target).reshape(-1)] = values.reshape(-1, *tail)
    return out.reshape(b, n + 1, *tail)[:, :n]


def _standard_nms(out_p, out_s, merged_valid, iou_threshold: float):
    """Exact greedy NMS over ([B,] M, 4, 2) quads → (([B,] M, 9) kept rows
    first, score-descending; zeros past the count, count ([B,]))."""
    if out_p.dim() == 3:
        out, n = _standard_nms(out_p[None], out_s[None], merged_valid[None], iou_threshold)
        return out[0], n[0]
    b, m = out_p.shape[:2]
    dev = out_p.device
    pair_cap = 16 * m  # per page
    ninf = torch.full_like(out_s, -float("inf"))
    bidx = torch.arange(b, device=dev)[:, None]

    nms_key = torch.where(merged_valid, out_s, ninf)
    nms_order = torch.sort(-nms_key, dim=1, stable=True).indices
    quads = out_p[bidx, nms_order]
    valid = merged_valid[bidx, nms_order]

    x1, x2 = quads[..., 0].amin(dim=2), quads[..., 0].amax(dim=2)
    y1, y2 = quads[..., 1].amin(dim=2), quads[..., 1].amax(dim=2)
    areas = _quad_area(quads)
    iw = (torch.minimum(x2[:, :, None], x2[:, None, :])
          - torch.maximum(x1[:, :, None], x1[:, None, :])).clamp_min(0.0)
    ih = (torch.minimum(y2[:, :, None], y2[:, None, :])
          - torch.maximum(y1[:, :, None], y1[:, None, :])).clamp_min(0.0)
    amax = torch.maximum(areas[:, :, None], areas[:, None, :])
    ub = (iw * ih) / amax.clamp_min(1e-12)

    idx = torch.arange(m, device=dev)
    lower = idx[None, :] < idx[:, None]  # j strictly earlier than i
    cand = (ub > iou_threshold) & lower & valid[:, :, None] & valid[:, None, :]

    # compact each page's candidate pairs (row-major) into its 16·M slots,
    # clip exactly only those: one launch for all pages
    flat = cand.reshape(b, m * m)
    slot = torch.cumsum(flat.to(torch.int64), 1) - 1
    within = flat & (slot < pair_cap)
    pair_idx = _scatter_rows(
        torch.arange(m * m, dtype=torch.int32, device=dev).expand(b, m * m),
        torch.where(within, slot, pair_cap), pair_cap, 0,
    )  # (B, pair_cap) row-major pair i·M + j of that page
    n_live = within.sum(dim=1, dtype=torch.int32)
    live_pair = torch.arange(pair_cap, device=dev)[None, :] < n_live[:, None]
    base = (bidx * m).to(torch.int32)
    exact = quad_iou_gather(
        quads.reshape(b * m, 4, 2),
        (base + pair_idx // m).reshape(-1), (base + pair_idx % m).reshape(-1), n_live,
    ).reshape(b, pair_cap)
    supp_pair = live_pair & (exact > iou_threshold)

    suppressor = _scatter_rows(
        supp_pair, torch.where(live_pair, pair_idx.long(), m * m), m * m, False
    ).reshape(b, m, m)
    # overflow pairs keep the conservative upper-bound decision
    suppressor |= cand & (slot.reshape(b, m, m) >= pair_cap)

    # the fixpoint runs until no page changes (one host sync per sweep)
    kept = valid
    for _ in range(m):
        new = valid & ~(suppressor & kept[:, None, :]).any(dim=2)
        changed = bool((new != kept).any())
        kept = new
        if not changed:
            break

    target = torch.where(kept, torch.cumsum(kept.to(torch.int64), 1) - 1, m)
    rows = torch.cat([quads.reshape(b, m, 8), out_s[bidx, nms_order, None]], dim=2)
    return _scatter_rows(rows, target, m, 0.0), kept.sum(dim=1)


def locality_aware_nms_parallel(
    cands: torch.Tensor, iou_threshold: float, max_out: int = 1024
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cands ([B,] K, 9) rows [x0..y3, score], score < 0 = padding →
    (boxes ([B,] max_out, 9) score-descending, zeros past count; count
    ([B,])). Each page of a chunk is merged and suppressed on its own."""
    if cands.dim() == 2:
        out, n = locality_aware_nms_parallel(cands[None], iou_threshold, max_out)
        return out[0], n[0]
    b, k = cands.shape[:2]
    dev = cands.device
    bidx = torch.arange(b, device=dev)[:, None]
    scores = cands[..., 8]
    valid = scores >= 0.0

    sort_key = torch.where(valid, cands[..., 0], torch.full_like(scores, float("inf")))
    order = torch.sort(sort_key, dim=1, stable=True).indices
    quads = cands[..., :8].reshape(b, k, 4, 2)[bidx, order]
    val = valid[bidx, order]
    sc = torch.where(val, scores[bidx, order], torch.zeros_like(scores))

    prev = torch.cat([quads[:, :1], quads[:, :-1]], dim=1)
    aligned = _normalize_quad(prev.reshape(b * k, 4, 2), quads.reshape(b * k, 4, 2))

    iou_prev = quad_iou_gather(
        quads.reshape(b * k, 4, 2), *_predecessor_pairs(b, k, dev)
    ).reshape(b, k - 1)
    same = val[:, 1:] & val[:, :-1] & (iou_prev > iou_threshold)
    brk = torch.cat([torch.ones(b, 1, dtype=torch.bool, device=dev), ~same], dim=1)
    seg = torch.cumsum(brk.to(torch.int64), 1) - 1
    seg = torch.where(val, seg, k)  # invalid rows → dump segment
    flat_seg = (bidx * (k + 1) + seg).reshape(-1)

    vert_sum = torch.zeros(b * (k + 1), 8, dtype=cands.dtype, device=dev).index_add_(
        0, flat_seg, aligned.reshape(b * k, 8) * sc.reshape(-1, 1)
    ).reshape(b, k + 1, 8)[:, :k]
    w_sum = torch.zeros(b * (k + 1), dtype=cands.dtype, device=dev).index_add_(
        0, flat_seg, sc.reshape(-1)
    ).reshape(b, k + 1)[:, :k]
    s_max = torch.full((b * (k + 1),), -float("inf"), dtype=cands.dtype, device=dev).scatter_reduce_(
        0, flat_seg, torch.where(val, sc, torch.full_like(sc, -float("inf"))).reshape(-1), "amax"
    ).reshape(b, k + 1)[:, :k]
    seg_valid = w_sum > 0
    merged = vert_sum / w_sum.clamp_min(1e-12)[..., None]

    # compact valid segments (x-sorted order) into the (max_out,) buffer
    pos = torch.cumsum(seg_valid.to(torch.int64), 1) - 1
    target = torch.where(seg_valid & (pos < max_out), pos, max_out)
    out_p = _scatter_rows(merged, target, max_out, 0.0).reshape(b, max_out, 4, 2)
    out_s = _scatter_rows(
        torch.where(seg_valid, s_max, torch.full_like(s_max, -float("inf"))),
        target, max_out, -float("inf"),
    )
    n = torch.clamp(seg_valid.sum(dim=1), max=max_out)
    merged_valid = torch.arange(max_out, device=dev)[None, :] < n[:, None]
    return _standard_nms(out_p, out_s, merged_valid, iou_threshold)
