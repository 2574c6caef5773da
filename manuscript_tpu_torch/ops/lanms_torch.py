"""Locality-aware NMS on the device (counterpart of
``manuscript_tpu/ops/lanms_jax.py``: ``_normalize_quad``,
``locality_aware_nms_parallel``, ``locality_aware_nms_jax`` and
``_standard_nms``).

1. Candidates are sorted by x0 (stable; invalid rows last).
   ``locality_aware_nms_parallel`` (the fused pipeline's) merges each into
   the chain of its PREDECESSOR when their IoU clears the threshold (the JAX
   package's documented delta from the host's running-average merge), and
   each chain becomes one score-weighted average quad.
   ``locality_aware_nms`` (the scan LANMS, ``EAST(nms="device")``) merges
   each into the RUNNING merged quad, as the host LANMS does: on the card
   the CUDA kernel K3 (``lanms_merge_scan`` in ``csrc/quad_iou.cu``), which
   walks chunks of the rows at once and rejoins the true chain where it
   breaks, with the outputs of one sequential walk; on the CPU a loop over
   the rows.
2. Exact greedy NMS over the merged quads as a fixpoint: a bounding-box upper
   bound on IoU picks the pairs that could suppress, up to 16·M of them are
   clipped exactly, pairs beyond that capacity keep the conservative bound,
   and kept[i] = valid[i] ∧ ¬∃ j<i: kept[j] ∧ IoU[j,i] > t is iterated until
   it stops changing (at most M sweeps; one host sync per sweep).

The functions take an optional leading page axis (the JAX package's
``vmap``): every page keeps its own candidate order, segments, 16·M pair
slots and fixpoint, and the sweeps go on until no page changes. The IoU
calls of the parallel merge and of the NMS go through
``ops.quad_iou.quad_iou_gather``: one launch each for the whole chunk on the
card, with int32 pair indices offset by each page's start and, for the
compacted pairs, one live count per page on the device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import _build
from .quad_iou import _lib, quad_iou_gather, quad_iou_pairs_plain

launches = 0  # K3 (lanms_merge_scan) kernel launches, for proof of the route

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


def _merge_step(state, q: torch.Tensor, s: torch.Tensor, iou_threshold: float):
    """One live row (quad q (4, 2), score s) of the merge walk on from the
    running quad ``state`` = (quad, score, weight), or None before the first
    row → (the new state, whether the row opened it). A row that opens a new
    quad closes ``state``."""
    if state is not None:
        cur_p, cur_s, cur_w = state
        if bool(quad_iou_pairs_plain(q[None], cur_p[None])[0] > iou_threshold):
            aligned = _normalize_quad(cur_p[None], q[None])[0]
            tot = cur_w + s
            den = torch.where(tot == 0, torch.ones_like(tot), tot)
            return ((cur_p * cur_w + aligned * s) / den, torch.maximum(cur_s, s), tot), False
    return (q, s, s), True


def lanms_merge_scan_plain(rows: torch.Tensor, iou_threshold: float, max_out: int):
    """The merge walk of the scan LANMS, one row after another in torch ops
    (the plain twin of K3). ``rows`` (B, K, 9): each page's candidates
    sorted by x0, padding (score < 0) last → (out_p (B, max_out, 4, 2), zeros
    past the count; out_s (B, max_out), −inf past it; count (B,) int32, the
    number of closed quads, which may exceed max_out: past it every quad
    lands in the last slot)."""
    b, k = rows.shape[:2]
    dev, dt = rows.device, rows.dtype
    out_p = torch.zeros(b, max_out, 4, 2, dtype=dt, device=dev)
    out_s = torch.full((b, max_out), -float("inf"), dtype=dt, device=dev)
    count = torch.zeros(b, dtype=torch.int32, device=dev)
    for page in range(b):
        quads, scores = rows[page, :, :8].reshape(k, 4, 2), rows[page, :, 8]
        state = None
        m = 0
        # padding rows change nothing: only the live rows are walked
        for i in torch.nonzero(scores >= 0.0).flatten().tolist():
            new, opened = _merge_step(state, quads[i], scores[i], iou_threshold)
            if opened and state is not None:
                slot = min(m, max_out - 1)
                out_p[page, slot], out_s[page, slot] = state[0], state[1]
                m += 1
            state = new
        if state is not None:
            slot = min(m, max_out - 1)
            out_p[page, slot], out_s[page, slot] = state[0], state[1]
            m += 1
        count[page] = m
    return out_p, out_s, count


# csrc/quad_iou.cu's K3_THREADS (a page's block at most) and K3_MIN_CHUNK
# (a default chunk's rows at least), and the re-walk limit passed to it
_K3_THREADS, _K3_MIN_CHUNK, _K3_REWALKS = 512, 8, 4


def _k3_threads(k: int, chunk=None) -> int:
    """The threads of K3's block for pages of ``k`` rows: one a chunk of
    ``chunk`` rows (None: of ``_K3_MIN_CHUNK``), a multiple of 32 up to
    ``_K3_THREADS``."""
    chunks = -(-k // (chunk or _K3_MIN_CHUNK))
    return max(32, min(_K3_THREADS, -(-chunks // 32) * 32))


def lanms_merge_scan_cuda(rows: torch.Tensor, iou_threshold: float, max_out: int,
                          _chunk=None, _rewalks=None, _stats=None):
    """K3 on the card: one launch, one block per page, each thread walking a
    chunk of the page's rows. ``_chunk`` (private) fixes the chunk length:
    None takes the live extent over ``_k3_threads(K)`` threads, at least
    ``_K3_MIN_CHUNK`` rows, and ``K`` walks the page with one thread;
    ``_rewalks`` (private, ``_K3_REWALKS`` by default) caps how often a
    chunk behind the first stale one walks again. Every setting gives the
    same outputs. A dict ``_stats`` (private) gets the kernel's record:
    ``fixup`` (B, 5) int32 (fix-up rounds, re-walks, rows re-walked, most
    rows of one re-walk, the chunk length) and ``code`` (B, K) int32 (0
    merged or padding, 1 opened the page's first quad, 2 closed a quad and
    opened the next)."""
    global launches
    if rows.device.type != "cuda":
        raise ValueError(f"lanms_merge_scan: rows are on {rows.device}, not CUDA")
    if rows.dtype != torch.float32:
        raise TypeError(f"lanms_merge_scan: rows are {rows.dtype}, needs float32")
    if rows.dim() != 3 or rows.shape[2] != 9 or not rows.is_contiguous():
        raise ValueError(
            f"lanms_merge_scan: rows must be contiguous (B, K, 9), got {tuple(rows.shape)}"
        )
    if max_out < 1:
        raise ValueError(f"lanms_merge_scan: max_out must be >= 1, got {max_out}")
    if _chunk is not None and _chunk < 1:
        raise ValueError(f"lanms_merge_scan: _chunk must be >= 1, got {_chunk}")
    rewalks = _K3_REWALKS if _rewalks is None else _rewalks
    if rewalks < 0:
        raise ValueError(f"lanms_merge_scan: _rewalks must be >= 0, got {_rewalks}")
    b, k = rows.shape[:2]
    dev = rows.device
    threads = _k3_threads(k, _chunk)
    # chunks a page can have: at most one a thread by default
    c_cap = max(-(-k // _chunk), threads) if _chunk else threads
    out_p = torch.empty(b, max_out, 4, 2, dtype=torch.float32, device=dev)
    out_s = torch.empty(b, max_out, dtype=torch.float32, device=dev)
    count = torch.empty(b, dtype=torch.int32, device=dev)
    # the record's codes past a page's last live row are never written: zeros
    iscratch = (torch.empty if _stats is None else torch.zeros)(
        b, k + 4 * c_cap, dtype=torch.int32, device=dev)
    fscratch = torch.empty(b, 9 * k + 20 * c_cap, dtype=torch.float32, device=dev)
    stats = torch.empty(b, 5, dtype=torch.int32, device=dev) if _stats is not None else None
    status = _lib().lanms_merge_scan_launch(
        rows.data_ptr(), b, k, float(iou_threshold), max_out, _chunk or 0, rewalks, threads,
        c_cap, out_p.data_ptr(), out_s.data_ptr(), count.data_ptr(), iscratch.data_ptr(),
        fscratch.data_ptr(), 0 if stats is None else stats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "lanms_merge_scan")
    launches += 1
    if _stats is not None:
        _stats.update(fixup=stats, code=iscratch[:, :k])
    return out_p, out_s, count


def lanms_merge_scan(rows: torch.Tensor, iou_threshold: float, max_out: int):
    """Plain torch ops for CPU tensors, the CUDA kernel K3 otherwise."""
    if rows.device.type == "cpu":
        return lanms_merge_scan_plain(rows, iou_threshold, max_out)
    return lanms_merge_scan_cuda(rows, iou_threshold, max_out)


def locality_aware_nms(
    cands: torch.Tensor, iou_threshold: float, max_out: int = 1024
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan LANMS: cands ([B,] K, 9) rows [x0..y3, score], score < 0 =
    padding → (boxes ([B,] max_out, 9) score-descending, zeros past count;
    count ([B,])), each candidate merged into the running merged quad."""
    if cands.dim() == 2:
        out, n = locality_aware_nms(cands[None], iou_threshold, max_out)
        return out[0], n[0]
    b = cands.shape[0]
    scores = cands[..., 8]
    sort_key = torch.where(scores >= 0.0, cands[..., 0], torch.full_like(scores, float("inf")))
    order = torch.sort(sort_key, dim=1, stable=True).indices
    rows = cands[torch.arange(b, device=cands.device)[:, None], order].contiguous()
    out_p, out_s, count = lanms_merge_scan(rows, iou_threshold, max_out)
    merged_valid = torch.arange(max_out, device=cands.device)[None, :] < count[:, None]
    return _standard_nms(out_p, out_s, merged_valid, iou_threshold)
