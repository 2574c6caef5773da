"""Quad decoding from EAST score/geometry maps (counterpart of
``manuscript_tpu/ops/decode.py``: ``decode_cells_jax`` and
``compact_candidates``), as fixed-shape tensor ops on the maps' device.

A q×q cell is a candidate when any of its pixels clears the threshold; its
score and 8 geometry offsets are sampled at the cell-centre pixel, and vertex
i is (centre + offset_i)·scale in input pixels.
"""

from __future__ import annotations

from typing import Tuple

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
    score_thresh: float,
    quantization: int = 1,
    scale: float = 4.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """score_map (H, W), geo_map (H, W, 8) → quads (Hc, Wc, 8) in input
    pixels, cell-centre scores (Hc, Wc), validity (Hc, Wc)."""
    h, w = score_map.shape
    q = quantization
    dev = score_map.device
    if q > 1:
        hc, wc = -(-h // q), -(-w // q)
        padded = F.pad(score_map, (0, wc * q - w, 0, hc * q - h), value=-float("inf"))
        cell_max = padded.reshape(hc, q, wc, q).amax(dim=(1, 3))
        cy = torch.as_tensor(_cell_centers(h, q), device=dev)
        cx = torch.as_tensor(_cell_centers(w, q), device=dev)
    else:
        hc, wc = h, w
        cell_max = score_map
        cy = torch.arange(h, device=dev)
        cx = torch.arange(w, device=dev)

    valid = cell_max > score_thresh
    scores = score_map[cy[:, None], cx[None, :]]
    geo = geo_map[cy[:, None], cx[None, :], :]
    fx = cx[None, :, None].to(geo.dtype)
    fy = cy[:, None, None].to(geo.dtype)
    vx = (fx + geo[:, :, 0::2]) * scale
    vy = (fy + geo[:, :, 1::2]) * scale
    quads = torch.stack([vx, vy], dim=-1).reshape(hc, wc, 8)
    return quads, scores, valid


def compact_candidates(
    quads: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, max_candidates: int
) -> torch.Tensor:
    """Valid cells into the first free slots in raster order → (K, 9) rows,
    unused slots with score −1. Over capacity the tail of the raster (the
    bottom of the page) is dropped."""
    flat_valid = valid.reshape(-1)
    k = min(max_candidates, flat_valid.shape[0])
    slot = torch.cumsum(flat_valid.to(torch.int64), 0) - 1
    within = flat_valid & (slot < k)
    target = torch.where(within, slot, k)
    rows = torch.cat([quads.reshape(-1, 8), scores.reshape(-1, 1)], dim=-1)
    out = torch.full((k + 1, 9), -1.0, dtype=rows.dtype, device=rows.device)
    out[target] = rows
    out = out[:k]
    live = torch.arange(k, device=rows.device) < within.sum()
    out[:, 8] = torch.where(live, out[:, 8], torch.full_like(out[:, 8], -1.0))
    return out
