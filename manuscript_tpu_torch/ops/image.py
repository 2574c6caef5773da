"""Host image ops of the page path, in numpy alone.

The JAX package resizes with OpenCV (``manuscript_tpu/ops/image.py``). The
port does not depend on OpenCV, so this module reproduces the two OpenCV
8-bit resize modes that path uses:

* INTER_LINEAR (``detector_preprocess_host``, and ``resize_and_pad`` when a
  crop grows): half-pixel source coordinates, weights rounded to 1/2048
  (11-bit fixed point), a horizontal pass in integers and a vertical pass
  that rounds the 22-bit product back to 8 bits. An exact 2× shrink of both
  axes goes to the 2×2 box average, as OpenCV does.
* INTER_AREA (``resize_and_pad`` when a crop shrinks; that branch shrinks
  both axes): OpenCV's area-coverage weights in float32, accumulated in its
  order, rounded half to even; an integer shrink of both axes is the box
  average.

``read_image`` imports cv2 (or PIL) only when it is given a path; with
neither installed it still reads PNG files, through ``decode_png`` (zlib and
numpy: 8-bit gray, gray + alpha, RGB and RGBA, not interlaced, all five row
filters). ``encode_png`` writes such files (8-bit gray or RGB, filter 0).

On tensors: ``normalize_u8`` (uint8 → (x/255 − 0.5)/0.5) and
``resize_bilinear`` (``jax.image.resize``'s "bilinear": half-pixel centres,
antialiased when it shrinks).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS  # 2048


def read_image(img_or_path: Union[str, Path, np.ndarray]) -> np.ndarray:
    """Load an image as an RGB uint8 ndarray; ndarray inputs pass through.
    A path is read with cv2 when it is installed, else with PIL."""
    if isinstance(img_or_path, np.ndarray):
        return img_or_path
    if isinstance(img_or_path, (str, Path)):
        path = str(img_or_path)
        try:
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is not None:
            img = cv2.imread(path)
            if img is not None:
                return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        try:
            from PIL import Image
        except ImportError:
            Image = None
        try:
            if Image is None:
                return to_rgb_u8(decode_png(Path(path).read_bytes()))
            with Image.open(path) as pil_img:
                return np.array(pil_img.convert("RGB"))
        except Exception as e:
            raise FileNotFoundError(f"Cannot read image: {path}. Error: {e}")
    if hasattr(img_or_path, "convert"):  # a PIL image
        return np.array(img_or_path.convert("RGB"))
    raise TypeError(f"Unsupported type for image input: {type(img_or_path)}")


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type → channels


def _unfilter_row(kind: int, row: np.ndarray, up: np.ndarray, bpp: int) -> np.ndarray:
    """Undo one PNG row filter (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    if kind == 0:
        return row
    if kind == 2:
        return row + up
    if kind == 1:  # running sum per byte lane, mod 256
        lanes = row.reshape(-1, bpp)
        return np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)
    out = bytearray(row.tobytes())
    prior = up.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit, non-interlaced PNG → (H, W) or (H, W, C) uint8."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, color type {color}, interlace {interlace}")
    ch = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * ch)
    out = np.empty((h, w * ch), np.uint8)
    up = np.zeros(w * ch, np.uint8)
    for y in range(h):
        up = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], up, ch)
    return out.reshape(h, w, ch)[..., 0] if ch == 1 else out.reshape(h, w, ch)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) gray or (H, W, 3) RGB uint8 → PNG bytes (filter 0, zlib level 6)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (_PNG_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def to_rgb_u8(img: np.ndarray) -> np.ndarray:
    """Coerce gray / RGBA ndarrays to 3-channel RGB."""
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    elif img.shape[2] == 4:
        img = img[:, :, :3]
    return img


# ---- INTER_LINEAR ----------------------------------------------------------


def _linear_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per output index: the first source index (half-pixel centres, not yet
    clamped) and the float32 fraction towards the next one."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    return s, f


def _coef(f: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The two weights (1 − f, f) in 11-bit fixed point, rounded half to even."""
    c0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(np.int64)
    c1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    return c0, c1


def _resize_linear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w = img.shape[:2]
    sy, fy = _linear_taps(h, out_h)
    by0, by1 = _coef(fy)
    y0 = np.clip(sy, 0, h - 1)  # rows clamped at the borders, weights kept
    y1 = np.clip(sy + 1, 0, h - 1)
    # horizontal pass over the source rows the output needs: integer sums
    # scaled by 2048; at the borders OpenCV clamps the column and drops the
    # fraction
    need, inv = np.unique(np.concatenate([y0, y1]), return_inverse=True)
    sx, fx = _linear_taps(w, out_w)
    fx = np.where((sx < 0) | (sx >= w - 1), np.float32(0), fx)
    sx = np.clip(sx, 0, w - 1)
    ax0, ax1 = (c.astype(np.int32)[None, :, None] for c in _coef(fx))
    src = img[need].astype(np.int32)
    rows = src[:, sx] * ax0 + src[:, np.minimum(sx + 1, w - 1)] * ax1
    # vertical pass as OpenCV's vector path: (S >> 4) · β keeping the high
    # 16 bits, then a rounding shift by 2
    rows >>= 4
    r0, r1 = rows[inv[:out_h]], rows[inv[out_h:]]
    out = (r0 * by0.astype(np.int32)[:, None, None]) >> 16
    out += (r1 * by1.astype(np.int32)[:, None, None]) >> 16
    out += 2
    out >>= 2
    return np.clip(out, 0, 255).astype(np.uint8)


# ---- INTER_AREA ------------------------------------------------------------


def _area_tab(src: int, dst: int):
    """OpenCV's computeResizeAreaTab: (dst index, src index, weight) triples
    in accumulation order — per output cell a partial head pixel, the whole
    pixels, and a partial tail pixel, in float64 like OpenCV."""
    scale = 1.0 / (dst / src)
    fs1 = np.arange(dst) * scale
    fs2 = fs1 + scale
    cell = np.minimum(scale, src - fs1)
    s2 = np.minimum(np.floor(fs2).astype(np.int64), src - 1)
    s1 = np.minimum(np.ceil(fs1).astype(np.int64), s2)
    n_mid = s2 - s1
    k = int(n_mid.max()) + 2
    col = np.arange(k)[None, :]
    si = np.concatenate([s1[:, None] - 1, s1[:, None] + col[:, : k - 2], s2[:, None]], 1)
    al = np.concatenate([
        ((s1 - fs1) / cell)[:, None],
        np.broadcast_to((1.0 / cell)[:, None], (dst, k - 2)),
        (np.minimum(np.minimum(fs2 - s2, 1.0), cell) / cell)[:, None],
    ], 1)
    live = np.concatenate([
        (s1 - fs1 > 1e-3)[:, None], col[:, : k - 2] < n_mid[:, None], (fs2 - s2 > 1e-3)[:, None],
    ], 1)
    di = np.broadcast_to(np.arange(dst)[:, None], (dst, k))
    return di[live], si[live], al[live].astype(np.float32)


def _accumulate(acc: np.ndarray, di, si, al, src: np.ndarray) -> np.ndarray:
    """acc[di] += src[si] · al along axis 0, one float32 add at a time in
    table order (entries of one output index are consecutive)."""
    order = np.arange(len(di)) - np.searchsorted(di, di)  # rank within its di
    for m in range(int(order.max()) + 1):
        sel = order == m
        d = di[sel]
        acc[d] = acc[d] + src[si[sel]] * al[sel][:, None, None]
    return acc


def _resize_area(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w, c = img.shape
    sx, sy = w / out_w, h / out_h
    if sx == int(sx) and sy == int(sy):  # integer shrink: box average
        kx, ky = int(sx), int(sy)
        blocks = img.astype(np.int64).reshape(out_h, ky, out_w, kx, c)
        total = blocks.sum(axis=(1, 3))
        if kx == 2 and ky == 2:
            return ((total + 2) >> 2).astype(np.uint8)
        scale = np.float32(1.0) / np.float32(kx * ky)
        return np.clip(np.rint(total.astype(np.float32) * scale), 0, 255).astype(np.uint8)
    xd, xs, xa = _area_tab(w, out_w)
    yd, ys, ya = _area_tab(h, out_h)
    cols = np.ascontiguousarray(img.transpose(1, 0, 2), dtype=np.float32)
    buf = _accumulate(np.zeros((out_w, h, c), np.float32), xd, xs, xa, cols)
    buf = np.ascontiguousarray(buf.transpose(1, 0, 2))
    out = _accumulate(np.zeros((out_h, out_w, c), np.float32), yd, ys, ya, buf)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize_u8(img: np.ndarray, out_h: int, out_w: int, area: bool = False) -> np.ndarray:
    """OpenCV-equivalent resize of an (H, W, C) uint8 image: INTER_LINEAR,
    or INTER_AREA when ``area`` (which this module only uses to shrink)."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img.copy()
    if area or (w == 2 * out_w and h == 2 * out_h):
        return _resize_area(img, out_h, out_w)
    return _resize_linear(img, out_h, out_w)


def resize_and_pad(
    img: np.ndarray,
    img_h: int,
    img_w: int,
    align_h: str = "left",
    align_v: str = "center",
) -> np.ndarray:
    """Aspect-preserving resize onto a white (255) canvas of (img_h, img_w).

    INTER_AREA when shrinking, INTER_LINEAR when growing; the scaled image is
    left-aligned horizontally and centered vertically by default, matching the
    recognizer's eval transform in the reference.
    """
    img = to_rgb_u8(img)
    h, w = img.shape[:2]
    scale = min(img_h / max(h, 1), img_w / max(w, 1))
    new_w = max(1, int(round(w * scale)))
    new_h = max(1, int(round(h * scale)))
    resized = resize_u8(img, new_h, new_w, area=img_h < h or img_w < w)

    canvas = np.full((img_h, img_w, 3), 255, dtype=img.dtype)
    if align_h == "left":
        x0 = 0
    elif align_h == "right":
        x0 = img_w - new_w
    else:
        x0 = (img_w - new_w) // 2
    if align_v == "top":
        y0 = 0
    elif align_v == "bottom":
        y0 = img_h - new_h
    else:
        y0 = (img_h - new_h) // 2
    x0 = max(0, min(x0, img_w - new_w))
    y0 = max(0, min(y0, img_h - new_h))
    canvas[y0 : y0 + new_h, x0 : x0 + new_w] = resized
    return canvas


def detector_preprocess_host(img: np.ndarray, target_size: int) -> np.ndarray:
    """Host resize to (target_size, target_size) RGB uint8 (INTER_LINEAR,
    as the reference's cv2.resize at infer time)."""
    return resize_u8(to_rgb_u8(img), target_size, target_size)


def crop_axis_aligned(image: np.ndarray, polygon: np.ndarray) -> Optional[np.ndarray]:
    """Crop the axis-aligned bounding box of ``polygon`` from ``image``:
    clamp to the image bounds, None for an empty crop."""
    try:
        x_min, y_min = np.min(polygon, axis=0)
        x_max, y_max = np.max(polygon, axis=0)
        h, w = image.shape[:2]
        x1 = max(0, int(x_min))
        y1 = max(0, int(y_min))
        x2 = min(w, int(x_max))
        y2 = min(h, int(y_max))
        region = image[y1:y2, x1:x2]
        return region if region.size > 0 else None
    except Exception:
        return None


def batch_resize_and_pad(images: Sequence[np.ndarray], img_h: int, img_w: int) -> np.ndarray:
    """N crops of any size → one (N, img_h, img_w, 3) uint8 batch
    (``resize_and_pad`` each)."""
    return np.stack([resize_and_pad(im, img_h, img_w) for im in images], axis=0)


def normalize_u8(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [0, 255] → (x/255 − 0.5)/0.5 in ``dtype``: the recognizers',
    the detector's and both trainers' input."""
    return (x.to(dtype) / 255.0 - 0.5) / 0.5


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of an NHWC (or HWC) float tensor, as
    ``jax.image.resize(..., "bilinear")``: half-pixel centres, antialiased
    when it shrinks."""
    if x.dim() == 3:
        return resize_bilinear(x[None], out_h, out_w)[0]
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)
