"""Quad decoding from EAST score/geometry maps (counterpart of
``manuscript_tpu/ops/decode.py``): ``decode_cells`` and
``compact_candidates`` as fixed-shape tensor ops on the maps' device, both
with an optional leading page axis (a chunk of pages, or one page's maps
under several thresholds, decodes in one pass, each page on its own); and on
the host ``compact_topk`` and ``decode_quads_numpy``.

A q×q cell is a candidate when any of its pixels clears the threshold; its
score and 8 geometry offsets are sampled at the cell-centre pixel, and vertex
i is (centre + offset_i)·scale in input pixels.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


def _cell_centers(size: int, q: int) -> np.ndarray:
    n_cells = -(-size // q)  # ceil
    centers = np.arange(n_cells) * q + q // 2
    return np.minimum(centers, size - 1)


def decode_cells(
    score_map: torch.Tensor,
    geo_map: torch.Tensor,
    score_thresh: Union[float, torch.Tensor],
    quantization: int = 1,
    scale: float = 4.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """score_map ([B,] H, W), geo_map ([B,] H, W, 8) → quads ([B,] Hc, Wc, 8)
    in input pixels, cell-centre scores ([B,] Hc, Wc), validity ([B,] Hc,
    Wc). ``score_thresh`` is a number or, with a page axis, one per page
    (a (B,) tensor)."""
    if score_map.dim() == 2:
        return tuple(t[0] for t in decode_cells(
            score_map[None], geo_map[None], score_thresh, quantization, scale
        ))
    b, h, w = score_map.shape
    q = quantization
    dev = score_map.device
    if q > 1:
        hc, wc = -(-h // q), -(-w // q)
        padded = F.pad(score_map, (0, wc * q - w, 0, hc * q - h), value=-float("inf"))
        cell_max = padded.reshape(b, hc, q, wc, q).amax(dim=(2, 4))
        cy = torch.as_tensor(_cell_centers(h, q), device=dev)
        cx = torch.as_tensor(_cell_centers(w, q), device=dev)
    else:
        hc, wc = h, w
        cell_max = score_map
        cy = torch.arange(h, device=dev)
        cx = torch.arange(w, device=dev)

    if isinstance(score_thresh, torch.Tensor):
        score_thresh = score_thresh.to(device=dev, dtype=score_map.dtype).reshape(-1, 1, 1)
    valid = cell_max > score_thresh
    scores = score_map[:, cy[:, None], cx[None, :]]
    geo = geo_map[:, cy[:, None], cx[None, :], :]
    fx = cx[None, :, None].to(geo.dtype)
    fy = cy[:, None, None].to(geo.dtype)
    vx = (fx + geo[..., 0::2]) * scale
    vy = (fy + geo[..., 1::2]) * scale
    quads = torch.stack([vx, vy], dim=-1).reshape(b, hc, wc, 8)
    return quads, scores, valid


def compact_candidates(
    quads: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, max_candidates: int
) -> torch.Tensor:
    """Valid cells into the first free slots in raster order → ([B,] K, 9)
    rows, unused slots with score −1. Over capacity the tail of the raster
    (the bottom of the page) is dropped."""
    if valid.dim() == 2:
        return compact_candidates(quads[None], scores[None], valid[None], max_candidates)[0]
    b = valid.shape[0]
    dev = quads.device
    flat_valid = valid.reshape(b, -1)
    k = min(max_candidates, flat_valid.shape[1])
    slot = torch.cumsum(flat_valid.to(torch.int64), 1) - 1
    within = flat_valid & (slot < k)
    page = torch.arange(b, device=dev)[:, None] * (k + 1)
    target = page + torch.where(within, slot, k)
    rows = torch.cat([quads.reshape(b, -1, 8), scores.reshape(b, -1, 1)], dim=-1)
    out = torch.full((b * (k + 1), 9), -1.0, dtype=rows.dtype, device=dev)
    out[target.reshape(-1)] = rows.reshape(-1, 9)
    out = out.reshape(b, k + 1, 9)[:, :k]
    live = torch.arange(k, device=dev)[None, :] < within.sum(dim=1, keepdim=True)
    out[..., 8] = torch.where(live, out[..., 8], torch.full_like(out[..., 8], -1.0))
    return out


def compact_topk(cands: np.ndarray) -> np.ndarray:
    """Host: the candidate rows without the score −1 padding, float32."""
    cands = np.asarray(cands)
    return cands[cands[:, 8] >= 0.0].astype(np.float32)


def decode_quads_numpy(
    score_map: np.ndarray,
    geo_map: np.ndarray,
    score_thresh: float,
    scale: float,
    quantization: int = 1,
) -> np.ndarray:
    """Host decode of one page's maps with the semantics above → (n, 9).
    ``score_map`` (H, W) or (1, H, W), ``geo_map`` (H, W, 8). With q > 1 a
    pixel above the threshold selects its cell's centre pixel, once."""
    if score_map.ndim == 3 and score_map.shape[0] == 1:
        score_map = score_map[0]
    ys, xs = np.where(score_map > score_thresh)
    if len(ys) == 0:
        return np.zeros((0, 9), dtype=np.float32)
    if quantization > 1:
        q = quantization
        coords = np.unique(np.column_stack([(ys // q) * q + q // 2, (xs // q) * q + q // 2]), axis=0)
        ys = np.minimum(coords[:, 0], score_map.shape[0] - 1)
        xs = np.minimum(coords[:, 1], score_map.shape[1] - 1)
    offs = geo_map[ys, xs]  # (n, 8)
    vx = (xs[:, None] + offs[:, 0::2]) * scale
    vy = (ys[:, None] + offs[:, 1::2]) * scale
    quads = np.stack([vx, vy], axis=-1).reshape(len(ys), 8)
    return np.concatenate([quads, score_map[ys, xs][:, None]], axis=1).astype(np.float32)
