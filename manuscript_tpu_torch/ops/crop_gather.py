"""Device crop-gather: detector boxes → recognizer-ready crops on the device
(counterpart of ``manuscript_tpu/ops/crop_gather.py``).

The ``crop_source="device"`` page path takes its word crops from the page copy
that phase A already holds on the device, so no crop goes through the host.
Semantics are the host path's: a clamped axis-aligned crop, then an
aspect-preserving resize onto a white canvas, left-aligned horizontally and
centred vertically. Sampling is bilinear with the cv2 pixel-centre convention
(src = (dst + 0.5) · src_size / dst_size − 0.5, edge-clamped).

``crop_resize_pad_mm`` is the path's form: separable bilinear weights as two
dense products, out = Ry · img · Rxᵀ per crop. These are plain large matrix
products (the JAX package leaves them to XLA, outside any Pallas kernel), so
here they are ``torch.matmul``. The JAX package's four-tap gather form,
``crop_resize_pad``, serves no page path and is not ported.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _box_geometry(boxes, h: int, w: int, out_h: int, out_w: int, aspect=(1.0, 1.0)):
    """Clamp boxes (N, 4) [x1, y1, x2, y2] to the image and place each crop on
    the canvas → (x1, y1, sx, sy, new_w, new_h, y_off), float32 (N,).

    ``aspect = (ax, ay)`` are the source → original axis scales: crops taken
    from the square detector copy of a non-square page cover (ch·ay, cw·ax)
    original pixels, and the canvas placement uses those original extents so
    that words keep their aspect; sampling stays in source coordinates."""
    f32 = torch.float32
    dev = boxes.device
    ax = torch.as_tensor(aspect[0], dtype=f32, device=dev)
    ay = torch.as_tensor(aspect[1], dtype=f32, device=dev)
    x1 = torch.clamp(torch.floor(boxes[:, 0]), 0, w - 1).to(f32)
    y1 = torch.clamp(torch.floor(boxes[:, 1]), 0, h - 1).to(f32)
    x2 = torch.clamp(torch.floor(boxes[:, 2]), 0, w).to(f32)
    y2 = torch.clamp(torch.floor(boxes[:, 3]), 0, h).to(f32)
    cw = torch.clamp_min(x2 - x1, 1.0)
    ch = torch.clamp_min(y2 - y1, 1.0)
    cw_orig = cw * ax
    ch_orig = ch * ay

    scale = torch.minimum(out_h / ch_orig, out_w / cw_orig)
    new_w = torch.clamp_min(torch.round(cw_orig * scale), 1.0)
    new_h = torch.clamp_min(torch.round(ch_orig * scale), 1.0)
    sx = cw / new_w  # the exact per-axis src/dst ratio, like cv2.resize
    sy = ch / new_h
    y_off = torch.floor((out_h - new_h) / 2.0)
    return x1, y1, sx, sy, new_w, new_h, y_off


def _canvas_mask(valid, new_w, new_h, y_off, out_h: int, out_w: int) -> torch.Tensor:
    """(N, out_h, out_w) True where a crop's resized pixels lie."""
    dev = new_w.device
    jj = torch.arange(out_w, dtype=torch.float32, device=dev)[None, None, :]
    ii = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :, None]
    inside = (
        (jj < new_w[:, None, None])
        & (ii >= y_off[:, None, None])
        & (ii < (y_off + new_h)[:, None, None])
    )
    return inside & valid[:, None, None]


def _to_u8(out: torch.Tensor, inside: torch.Tensor) -> torch.Tensor:
    out = torch.where(inside[..., None], out, torch.full_like(out, 255.0))
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)


def crop_resize_pad_mm(
    img_u8: torch.Tensor,
    boxes: torch.Tensor,
    valid: torch.Tensor,
    out_h: int = 64,
    out_w: int = 256,
    dtype: torch.dtype = torch.float32,
    aspect: Tuple = (1.0, 1.0),
) -> torch.Tensor:
    """img_u8 (H, W, 3) uint8, boxes (N, 4) float [x1, y1, x2, y2] in image
    pixels, valid (N,) bool → (N, out_h, out_w, 3) uint8; invalid rows are
    white.

    Bilinear resampling as two products with hat-function weights (at most
    2 non-zeros a row; clamped source coordinates give cv2's border
    replication): the row pass is one (N·out_h, H) × (H, W·3) product, the
    column pass a batched (out_w, W) × (W, out_h·3) one. ``dtype`` is the
    row pass's input type, as in the JAX package: bfloat16 rounds the hat
    weights (pixel values ≤ 255 are exact in it), and the product sums in
    float32 either way — its inputs are rounded to ``dtype`` and multiplied
    in float32. The column pass is float32 (with TF32 off, torch's default
    for matrix products on the card)."""
    h, w = img_u8.shape[:2]
    f32 = torch.float32
    dev = img_u8.device
    n = boxes.shape[0]
    x1, y1, sx, sy, new_w, new_h, y_off = _box_geometry(boxes, h, w, out_h, out_w, aspect)

    jj = torch.arange(out_w, dtype=f32, device=dev)
    ii = torch.arange(out_h, dtype=f32, device=dev)
    src_x = x1[:, None] + (jj[None, :] + 0.5) * sx[:, None] - 0.5  # (N, out_w)
    src_y = y1[:, None] + (ii[None, :] - y_off[:, None] + 0.5) * sy[:, None] - 0.5
    src_x = torch.clamp(src_x, 0.0, w - 1.0)
    src_y = torch.clamp(src_y, 0.0, h - 1.0)

    rows = torch.arange(h, dtype=f32, device=dev)
    cols = torch.arange(w, dtype=f32, device=dev)
    ry = torch.clamp_min(1.0 - torch.abs(src_y[:, :, None] - rows), 0.0)  # (N, oh, H)
    rx = torch.clamp_min(1.0 - torch.abs(src_x[:, :, None] - cols), 0.0)  # (N, ow, W)

    img_f = img_u8.to(dtype).to(f32).reshape(h, w * 3)
    ry = ry.to(dtype).to(f32)
    tmp = (ry.reshape(n * out_h, h) @ img_f).reshape(n, out_h, w, 3)  # row pass
    # column pass: (N, ow, W) @ (N, W, oh·3) → (N, ow, oh, 3)
    out = rx @ tmp.permute(0, 2, 1, 3).reshape(n, w, out_h * 3)
    out = out.reshape(n, out_w, out_h, 3).permute(0, 2, 1, 3)
    return _to_u8(out, _canvas_mask(valid, new_w, new_h, y_off, out_h, out_w))

