"""The port's device crop-gather against the JAX package on the CPU: seeded
pages and boxes (boxes across the page edges, degenerate and invalid rows),
with ``aspect`` 1 and ≠ 1. The matrix form in float32 is within 1 level on at
most 0.1 % of the pixels, in bfloat16 within 1 level (the JAX package's CPU
products may round its bf16 sums in another order). The four-tap gather form,
which no page path runs, lives here as a witness: built on the port's box
geometry, it equals the JAX package's gather form and agrees with the matrix
form."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manuscript_tpu.ops.crop_gather import crop_resize_pad as j_gather
from manuscript_tpu.ops.crop_gather import crop_resize_pad_mm as j_mm
from manuscript_tpu_torch.ops.crop_gather import (
    _box_geometry,
    _canvas_mask,
    _to_u8,
    crop_resize_pad_mm,
)


def crop_resize_pad(img_u8, boxes, valid, out_h=64, out_w=256, aspect=(1.0, 1.0)):
    """The crops of ``crop_resize_pad_mm`` by gathering the four taps of
    each output pixel (float32 throughout)."""
    h, w = img_u8.shape[:2]
    f32 = torch.float32
    n = boxes.shape[0]
    x1, y1, sx, sy, new_w, new_h, y_off = _box_geometry(boxes, h, w, out_h, out_w, aspect)
    jj = torch.arange(out_w, dtype=f32)[None, None, :]
    ii = torch.arange(out_h, dtype=f32)[None, :, None]
    b = lambda v: v[:, None, None]  # noqa: E731 — broadcast (N,) over (h, w)
    src_x = (b(x1) + (jj + 0.5) * b(sx) - 0.5).expand(n, out_h, out_w)
    src_y = (b(y1) + (ii - b(y_off) + 0.5) * b(sy) - 0.5).expand(n, out_h, out_w)
    x0 = torch.clamp(torch.floor(src_x), 0, w - 1)
    y0 = torch.clamp(torch.floor(src_y), 0, h - 1)
    fx = torch.clamp(src_x - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(src_y - y0, 0.0, 1.0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    x1i = torch.clamp_max(x0i + 1, w - 1)
    y1i = torch.clamp_max(y0i + 1, h - 1)
    flat = img_u8.reshape(h * w, 3)

    def gat(yi, xi):
        return flat[(yi * w + xi).reshape(-1)].to(f32).reshape(n, out_h, out_w, 3)

    top = gat(y0i, x0i) * (1.0 - fx) + gat(y0i, x1i) * fx
    bot = gat(y1i, x0i) * (1.0 - fx) + gat(y1i, x1i) * fx
    out = top * (1.0 - fy) + bot * fy
    return _to_u8(out, _canvas_mask(valid, new_w, new_h, y_off, out_h, out_w))


def page_and_boxes(seed, h=96, w=128, n=16):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    x1, y1 = rng.uniform(-12, w - 4, n), rng.uniform(-12, h - 4, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(0.5, 70, n), y1 + rng.uniform(0.5, 30, n)], 1)
    boxes[0] = [-5, -5, w + 5, h + 5]  # the whole page and past its edges
    boxes[1] = [w - 1, h - 1, w + 3, h + 3]  # the last pixel
    boxes[2] = [10, 10, 10, 10]  # empty: clamped to one pixel
    valid = rng.uniform(size=n) > 0.2
    valid[:3] = True
    return img, boxes.astype(np.float32), valid


def _levels(a, b):
    return np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))


@pytest.mark.parametrize("seed,aspect", [(0, (1.0, 1.0)), (1, (1.5, 0.75)), (2, (0.6, 1.3))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crop_resize_pad_mm_matches_jax(seed, aspect, dtype):
    img, boxes, valid = page_and_boxes(seed)
    ref = j_mm(jnp.asarray(img), jnp.asarray(boxes), jnp.asarray(valid), 32, 128,
               dtype=getattr(jnp, dtype), aspect=aspect)
    got = crop_resize_pad_mm(torch.from_numpy(img), torch.from_numpy(boxes),
                             torch.from_numpy(valid), 32, 128,
                             dtype=getattr(torch, dtype), aspect=aspect)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (16, 32, 128, 3)
    d = _levels(got.numpy(), ref)
    assert d.max() <= 1
    if dtype == "float32":
        assert (d > 0).mean() <= 1e-3
    assert np.all(got.numpy()[~valid] == 255)


@pytest.mark.parametrize("seed,aspect", [(3, (1.0, 1.0)), (4, (1.25, 0.8))])
def test_crop_resize_pad_matches_jax(seed, aspect):
    img, boxes, valid = page_and_boxes(seed)
    ref = j_gather(jnp.asarray(img), jnp.asarray(boxes), jnp.asarray(valid), 32, 128, aspect=aspect)
    got = crop_resize_pad(torch.from_numpy(img), torch.from_numpy(boxes),
                          torch.from_numpy(valid), 32, 128, aspect=aspect)
    assert _levels(got.numpy(), ref).max() == 0


def test_matrix_and_gather_forms_agree():
    img, boxes, valid = page_and_boxes(5)
    args = (torch.from_numpy(img), torch.from_numpy(boxes), torch.from_numpy(valid), 64, 256)
    d = _levels(crop_resize_pad_mm(*args).numpy(), crop_resize_pad(*args).numpy())
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
