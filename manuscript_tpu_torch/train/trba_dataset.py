"""TRBA training data (counterpart of ``manuscript_tpu/train/trba_dataset.py``):
CSV/TSV label files and image folders, in numpy alone.

The label reader takes the delimiter from the extension (``.tsv``/``.txt``
tab, else comma) and skips a header row; paths resolve per root, then
through a basename index of the roots; ``OCRDataset`` validates rows in
threads with a categorized skip report (missing file, charset, too long) and
replaces an unreadable image lazily by a random other one (at most 8 times).
``proportional_batches`` draws from the same numpy ``default_rng`` streams
as the JAX package, so the batch order is equal; ``collate_attention`` packs
the targets with ``recognizers.charset.pack_targets``.

``augment_word_image`` is the JAX package's augmentation without cv2: the
shift-scale-rotate is ``rotation_matrix`` (cv2's ``getRotationMatrix2D``)
and ``warp_affine`` (cv2's ``warpAffine`` with bilinear sampling and a white
constant border, computed in float32 as OpenCV 5 does: against cv2 5.0 at
most 1 grey level apart, on under 0.1 % of the pixels), and the down-and-up
rescale is the port's byte-equal INTER_LINEAR.
"""

from __future__ import annotations

import csv
import math
import os
from collections import Counter, defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..ops.image import read_image, resize_and_pad, resize_u8, to_rgb_u8
from ..recognizers.charset import pack_targets

IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff"}


def build_file_index(roots: Union[str, Sequence[str]]) -> Dict[str, List[str]]:
    """Recursive basename (lower case) → paths index of the image files."""
    if isinstance(roots, str):
        roots = [roots]
    index: Dict[str, List[str]] = defaultdict(list)
    for root in roots:
        if not os.path.isdir(root):
            continue
        for dirpath, _, filenames in os.walk(root):
            for fn in filenames:
                if os.path.splitext(fn)[1].lower() in IMG_EXTS:
                    index[fn.lower()].append(os.path.join(dirpath, fn))
    return index


def read_label_file(path: str) -> List[Tuple[str, str]]:
    """CSV (,) or TSV (\\t) of (filename, text); a header row is skipped."""
    delimiter = "\t" if str(path).lower().endswith((".tsv", ".txt")) else ","
    rows: List[Tuple[str, str]] = []
    with open(path, "r", encoding="utf-8", newline="") as f:
        for i, row in enumerate(csv.reader(f, delimiter=delimiter)):
            if len(row) < 2:
                continue
            name, text = row[0], row[1]
            if i == 0 and name.strip().lower() in {
                "filename", "file", "image", "path", "img", "image_path",
            }:
                continue
            rows.append((name, text))
    return rows


class AugmentParams:
    """Train-time augmentation knobs, with the JAX package's defaults."""

    def __init__(
        self,
        shift_limit: float = 0.03,
        scale_limit: float = 0.08,
        rotate_limit: float = 3.0,
        p_shift_scale_rotate: float = 0.3,
        brightness_limit: float = 0.2,
        contrast_limit: float = 0.2,
        p_brightness_contrast: float = 0.3,
        invert_p: float = 0.0,
        p_downscale: float = 0.0,
        downscale_min: float = 0.4,
        downscale_max: float = 0.75,
    ):
        self.shift_limit = shift_limit
        self.scale_limit = scale_limit
        self.rotate_limit = rotate_limit
        self.p_shift_scale_rotate = p_shift_scale_rotate
        self.brightness_limit = brightness_limit
        self.contrast_limit = contrast_limit
        self.p_brightness_contrast = p_brightness_contrast
        self.invert_p = invert_p
        self.p_downscale = p_downscale
        self.downscale_min = downscale_min
        self.downscale_max = downscale_max

    @classmethod
    def from_config(cls, cfg: Dict) -> "AugmentParams":
        return cls(
            shift_limit=cfg.get("shift_limit", 0.03),
            scale_limit=cfg.get("scale_limit", 0.08),
            rotate_limit=cfg.get("rotate_limit", 3),
            p_shift_scale_rotate=cfg.get("p_ShiftScaleRotate", 0.3),
            brightness_limit=cfg.get("brightness_limit", 0.2),
            contrast_limit=cfg.get("contrast_limit", 0.2),
            p_brightness_contrast=cfg.get("p_BrightnessContrast", 0.3),
            invert_p=cfg.get("invert_p", 0.0),
            p_downscale=cfg.get("p_Downscale", 0.0),
            downscale_min=cfg.get("downscale_min", 0.4),
            downscale_max=cfg.get("downscale_max", 0.75),
        )


def rotation_matrix(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: a (2, 3) float64 matrix, ``angle`` in degrees
    counter-clockwise about ``center`` (a float32 point, as cv2 takes it)."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = (float(np.float32(v)) for v in center)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2.invertAffineTransform, in float64."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * d, m[0, 0] * d, -m[0, 1] * d, -m[1, 0] * d
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]])


def warp_affine(img: np.ndarray, m: np.ndarray, border: int = 255) -> np.ndarray:
    """cv2.warpAffine(img, m, (w, h)) with bilinear sampling and a constant
    border: each output pixel samples the source at m⁻¹·(x, y) in float32, a
    tap outside the image reads ``border``, and the result rounds to
    nearest."""
    h, w = img.shape[:2]
    f32 = np.float32
    im = _invert_affine(m).astype(f32)
    xs, ys = np.arange(w, dtype=f32), np.arange(h, dtype=f32)
    sx_f = im[0, 0] * xs[None, :] + (im[0, 1] * ys[:, None] + im[0, 2])
    sy_f = im[1, 0] * xs[None, :] + (im[1, 1] * ys[:, None] + im[1, 2])
    x0, y0 = np.floor(sx_f).astype(np.int64), np.floor(sy_f).astype(np.int64)
    ax = (sx_f - x0).astype(f32)[..., None]
    ay = (sy_f - y0).astype(f32)[..., None]
    src = img.reshape(h, w, -1).astype(f32)

    def tap(yy, xx):
        inside = ((xx >= 0) & (xx < w) & (yy >= 0) & (yy < h))[..., None]
        return np.where(inside, src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)], f32(border))

    top = tap(y0, x0) + ax * (tap(y0, x0 + 1) - tap(y0, x0))
    bot = tap(y0 + 1, x0) + ax * (tap(y0 + 1, x0 + 1) - tap(y0 + 1, x0))
    out = np.clip(np.rint(top + ay * (bot - top)), 0, 255).astype(np.uint8)
    return out.reshape(img.shape)


def augment_word_image(img: np.ndarray, rng: np.random.Generator, p: AugmentParams) -> np.ndarray:
    """Shift-scale-rotate on a white border, brightness/contrast, invert and
    the down-and-up rescale, each with its probability; the draws are the
    JAX package's, in its order."""
    out = img
    if rng.uniform() < p.p_shift_scale_rotate:
        h, w = out.shape[:2]
        angle = rng.uniform(-p.rotate_limit, p.rotate_limit)
        scale = 1.0 + rng.uniform(-p.scale_limit, p.scale_limit)
        tx = rng.uniform(-p.shift_limit, p.shift_limit) * w
        ty = rng.uniform(-p.shift_limit, p.shift_limit) * h
        m = rotation_matrix((w / 2, h / 2), angle, scale)
        m[:, 2] += (tx, ty)
        out = warp_affine(out, m, 255)
    if rng.uniform() < p.p_brightness_contrast:
        f = out.astype(np.float32)
        f = f * (1.0 + rng.uniform(-p.contrast_limit, p.contrast_limit))
        f = f + rng.uniform(-p.brightness_limit, p.brightness_limit) * 255.0
        out = np.clip(f, 0, 255).astype(np.uint8)
    if rng.uniform() < p.invert_p:
        out = 255 - out
    if rng.uniform() < p.p_downscale:
        h, w = out.shape[:2]
        f = rng.uniform(p.downscale_min, p.downscale_max)
        small = resize_u8(out, max(1, int(h * f)), max(1, int(w * f)))
        out = resize_u8(small, h, w)
    return out


class OCRDataset:
    """Validated (image, text) dataset for attention training; an item is
    (uint8 (img_h, img_w, 3) crop, text)."""

    def __init__(
        self,
        label_file: str,
        image_root: Union[str, Sequence[str]],
        stoi: Dict[str, int],
        max_len: int = 25,
        img_h: int = 64,
        img_w: int = 256,
        augment: bool = False,
        augment_params: Optional[AugmentParams] = None,
        charset_strict: bool = True,
        num_validation_threads: int = 8,
        seed: int = 0,
        name: Optional[str] = None,
    ):
        self.stoi = stoi
        self.max_len = max_len
        self.img_h = img_h
        self.img_w = img_w
        self.augment = augment
        self.augment_params = augment_params or AugmentParams()
        self.rng = np.random.default_rng(seed)
        self.name = name or Path(label_file).stem

        roots = [image_root] if isinstance(image_root, str) else list(image_root)
        rows = read_label_file(label_file)
        index = build_file_index(roots)
        specials = {v for k, v in stoi.items() if k.startswith("<")}

        def validate(row):
            name_, text = row
            path = next((os.path.join(r, name_) for r in roots
                         if os.path.exists(os.path.join(r, name_))), None)
            if path is None:
                hits = index.get(os.path.basename(name_).lower())
                path = hits[0] if hits else None
            if path is None:
                return None, "missing_file", text
            if len(text) > max_len:
                return None, "too_long", text
            if charset_strict:
                for ch in text:
                    if ch not in stoi or stoi[ch] in specials:
                        return None, "charset", ch
            return (path, text), None, None

        skip_reasons: Counter = Counter()
        missing_chars: Counter = Counter()
        samples: List[Tuple[str, str]] = []
        with ThreadPoolExecutor(max_workers=num_validation_threads) as ex:
            for result, reason, payload in ex.map(validate, rows):
                if result is not None:
                    samples.append(result)
                else:
                    skip_reasons[reason] += 1
                    if reason == "charset":
                        missing_chars[payload] += 1
        self.samples = samples
        self.skip_report = dict(skip_reasons)
        self.missing_chars_top = missing_chars.most_common(30)
        if skip_reasons:
            print(
                f"[OCRDataset:{self.name}] kept {len(samples)}/{len(rows)} rows; "
                f"skipped: {dict(skip_reasons)}"
                + (f"; top missing chars: {self.missing_chars_top[:10]}" if missing_chars else "")
            )

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int, _retries: int = 8):
        path, text = self.samples[idx]
        try:
            img = read_image(path)
        except Exception:
            # lazy skip of an unreadable image: a bounded random substitute
            if _retries <= 0:
                raise
            alt = int(self.rng.integers(0, len(self.samples)))
            return self.__getitem__(alt, _retries - 1)
        img = to_rgb_u8(img)
        if self.augment:
            img = augment_word_image(img, self.rng, self.augment_params)
        return resize_and_pad(img, self.img_h, self.img_w), text


class MultiDataset:
    """Index union of several datasets by (dataset_idx, sample_idx)."""

    def __init__(self, datasets: Sequence[OCRDataset]):
        self.datasets = list(datasets)
        self.flat = [(d, i) for d, ds in enumerate(self.datasets) for i in range(len(ds))]

    def __len__(self):
        return len(self.flat)

    def __getitem__(self, idx):
        d, i = self.flat[idx]
        return self.datasets[d][i]


def proportional_batches(
    datasets: Sequence,
    proportions: Sequence[float],
    batch_size: int,
    seed: int = 0,
) -> Iterator[List[Tuple[int, int]]]:
    """Batches of (dataset_idx, sample_idx) mixing the datasets at fixed
    proportions; each dataset reshuffles on its own when exhausted, and an
    epoch ends when the largest stream has been read once."""
    props = np.asarray(proportions, dtype=np.float64)
    props = props / props.sum()
    counts = np.round(props * batch_size).astype(int)
    counts[0] += batch_size - counts.sum()  # exact batch size

    rngs = [np.random.default_rng(seed + i) for i in range(len(datasets))]
    orders = [rngs[i].permutation(len(d)) for i, d in enumerate(datasets)]
    cursors = [0] * len(datasets)
    main = int(np.argmax(counts))
    n_batches = max(1, len(datasets[main]) // max(counts[main], 1))
    for _ in range(n_batches):
        batch: List[Tuple[int, int]] = []
        for d, c in enumerate(counts):
            for _ in range(c):
                if cursors[d] >= len(orders[d]):
                    orders[d] = rngs[d].permutation(len(datasets[d]))
                    cursors[d] = 0
                batch.append((d, int(orders[d][cursors[d]])))
                cursors[d] += 1
        yield batch


def collate_attention(
    items: Sequence[Tuple[np.ndarray, str]],
    stoi: Dict[str, int],
    max_len: int,
) -> Dict[str, np.ndarray]:
    """Stack the crops and pack SOS/EOS/PAD targets for the decoder."""
    texts = [it[1] for it in items]
    text_in, target_y, lengths = pack_targets(texts, stoi, max_len)
    return {
        "image": np.stack([it[0] for it in items]),
        "text_in": text_in,
        "target_y": target_y,
        "lengths": lengths,
        "texts": texts,
    }
