"""TPS rectification in front of the TRBA CNN (counterpart of
``manuscript_tpu/models/tps.py``; ``TRBAModel(use_tps=True)``).

A localization CNN predicts K fiducial points; a thin-plate spline maps the
canonical fiducial frame (K/2 points along the top edge, K/2 along the
bottom, in [-1, 1]²) onto them, and the input is resampled bilinearly on the
warped grid. The last localization layer starts at zero weights with the
canonical frame as its bias, so an untrained TPS is the identity warp.

The TPS system matrix is inverted in float64 on the host and cast to
float32, and the grid basis is built in numpy, as the JAX package does; both
are cached per output size and device. The two small products that map the
fiducials to the sampling grid run in float64 and the grid is rounded to
float32 once: the JAX package sums them in float32, which leaves ≈3e-5 of
the half-width of noise that depends on the order of the sums, so the card
and the CPU would sample at points ~1e-3 px apart. The submodules carry flax's
automatic names (``localization.Conv_0..3``, ``BatchNorm_0..3``,
``Dense_0``, ``Dense_1``), so ``utils/weights.params_from_jax`` and
``params_to_jax`` map a JAX ``use_tps=True`` variable tree without a rule of
their own.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, conv

LOCALIZATION_WIDTHS = (64, 128, 256, 512)


def canonical_fiducials(k: int) -> np.ndarray:
    """K fiducial points in [-1, 1]²: K/2 on the top edge, K/2 on the bottom."""
    half = k // 2
    x = np.linspace(-1.0, 1.0, half)
    top = np.stack([x, -np.ones(half)], axis=1)
    bottom = np.stack([x, np.ones(half)], axis=1)
    return np.concatenate([top, bottom], axis=0).astype(np.float32)


def _tps_u(d2: np.ndarray) -> np.ndarray:
    """TPS radial basis U = r² log r² (0 at r = 0)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(d2 == 0, 0.0, d2 * np.log(np.maximum(d2, 1e-12)))


def tps_system_inverse(c: np.ndarray) -> np.ndarray:
    """Inverse of the (K+3, K+3) TPS system matrix of base fiducials C,
    solved in float64 and returned as float32."""
    k = c.shape[0]
    d2 = np.sum((c[:, None, :] - c[None, :, :]) ** 2, axis=-1)
    mat = np.zeros((k + 3, k + 3), dtype=np.float64)
    mat[:k, :k] = _tps_u(d2)
    mat[:k, k] = 1.0
    mat[:k, k + 1 :] = c
    mat[k, :k] = 1.0
    mat[k + 1 :, :k] = c.T
    return np.linalg.inv(mat).astype(np.float32)


def build_grid_basis(c: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H·W, K+3) basis [U(P, C), 1, P] at the output grid's pixel centres."""
    ys = (np.arange(out_h) + 0.5) / out_h * 2 - 1
    xs = (np.arange(out_w) + 0.5) / out_w * 2 - 1
    gx, gy = np.meshgrid(xs, ys)
    p = np.stack([gx.ravel(), gy.ravel()], axis=1)
    d2 = np.sum((p[:, None, :] - c[None, :, :]) ** 2, axis=-1)
    ones = np.ones((p.shape[0], 1))
    return np.concatenate([_tps_u(d2), ones, p], axis=1).astype(np.float32)


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of NHWC images at normalized (x, y) points.

    img (B, H, W, C), grid (B, N, 2) in [-1, 1] with pixel centres at
    half-pixel offsets (align_corners=False) → (B, N, C). A coordinate is
    clamped to [0, size − 1] in pixels before the floor (border padding), so
    its gradient is 0 outside the image, as the JAX gather's is.
    """
    out = F.grid_sample(
        img.permute(0, 3, 1, 2), grid[:, None], mode="bilinear",
        padding_mode="border", align_corners=False,
    )  # (B, C, 1, N)
    return out[:, :, 0].permute(0, 2, 1)


class LocalizationNetwork(nn.Module):
    """4 × (3×3 conv, BatchNorm, ReLU, 2×2 max pool) → mean pool → Dense 256
    + ReLU → Dense 2K, identity-initialised. NHWC in, (B, K, 2) out."""

    def __init__(self, num_fiducials: int = 20, in_channels: int = 3):
        super().__init__()
        self.num_fiducials = num_fiducials
        cin = in_channels
        for i, ch in enumerate(LOCALIZATION_WIDTHS):
            self.add_module(f"Conv_{i}", conv(cin, ch, 3, 1, 1))
            self.add_module(f"BatchNorm_{i}", BatchNorm(ch))
            cin = ch
        self.Dense_0 = nn.Linear(cin, 256)
        self.Dense_1 = nn.Linear(256, 2 * num_fiducials)
        self.identity_init_()

    @torch.no_grad()
    def identity_init_(self) -> None:
        """The last layer as the JAX module initialises it: zero weights, the
        canonical frame as bias."""
        self.Dense_1.weight.zero_()
        self.Dense_1.bias.copy_(torch.from_numpy(canonical_fiducials(self.num_fiducials).ravel()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a contiguous NCHW copy: on the channels-last view of an NHWC batch
        # cuDNN picks float32 FFT convolutions with a workspace of many GiB
        x = x.permute(0, 3, 1, 2).contiguous()
        for i in range(len(LOCALIZATION_WIDTHS)):
            x = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(x), relu=True)
            x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.Dense_0(x.mean(dim=(2, 3))))
        return self.Dense_1(x).reshape(-1, self.num_fiducials, 2)


class TPSTransformer(nn.Module):
    """Localize fiducials → TPS grid → resample. NHWC in and out; the output
    size is the input's unless ``out_h``/``out_w`` are set. The grid (from
    float64 products) and the sampling are float32, autocast off, whatever
    the localization network computes in; the output takes the input's
    dtype."""

    def __init__(self, num_fiducials: int = 20, out_h: int = 0, out_w: int = 0):
        super().__init__()
        self.num_fiducials, self.out_h, self.out_w = num_fiducials, out_h, out_w
        self.localization = LocalizationNetwork(num_fiducials)
        self._consts: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def _constants(self, out_h: int, out_w: int, device: torch.device):
        key = (out_h, out_w, str(device))
        if key not in self._consts:
            c = canonical_fiducials(self.num_fiducials)
            self._consts[key] = (  # the float32 constants, held as float64
                torch.from_numpy(tps_system_inverse(c)).double().to(device),
                torch.from_numpy(build_grid_basis(c, out_h, out_w)).double().to(device),
            )
        return self._consts[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        out_h, out_w = self.out_h or x.shape[1], self.out_w or x.shape[2]
        fiducials = self.localization(x)  # (B, K, 2)
        inv, basis = self._constants(out_h, out_w, x.device)
        with torch.autocast(x.device.type, enabled=False):
            fiducials = fiducials.float().double()
            rhs = torch.cat([fiducials, fiducials.new_zeros((b, 3, 2))], dim=1)  # (B, K+3, 2)
            theta = torch.einsum("ij,bjc->bic", inv, rhs)
            grid = torch.einsum("nj,bjc->bnc", basis, theta).float()  # (B, N, 2)
            sampled = grid_sample_bilinear(x.float(), grid)
        # NHWC in memory, as the input was: the CNN behind then runs on the
        # same channels-last view as without TPS (PERF.md)
        return sampled.reshape(b, out_h, out_w, x.shape[-1]).to(x.dtype).contiguous()
