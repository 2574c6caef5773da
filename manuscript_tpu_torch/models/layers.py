"""Small layers shared by the port's networks (NCHW inside a network)."""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.batch_norm import batch_norm
from ..parallel.mesh import sum_over_ranks


class BatchNorm(nn.Module):
    """BatchNorm over channel dim 1 with flax ``nn.BatchNorm`` semantics
    (momentum 0.9, epsilon 1e-5); ``weight`` and ``bias`` are parameters,
    ``running_mean`` and ``running_var`` buffers. ``forward(x, residual=None,
    relu=False)`` returns act(BN(x) + residual): the residual added after the
    normalization and ReLU last, when asked for.

    In eval mode it normalizes with the running statistics (``F.batch_norm``),
    then adds the residual and applies the ReLU as ops of their own, the
    ReLU in place on the tensor just made: the module call holds ``x`` until
    it returns, so a ReLU of its own output would add a third activation to
    the peak where the composed call sites held two.

    In train mode it normalizes with the batch mean and the biased batch
    variance in at least float32, (x − mean)·rsqrt(var + eps)·weight + bias,
    and differentiates through them. Unless ``update_stats`` is False (SAM's
    perturbed pass sets it through ``frozen_batch_stats``), the running
    statistics then move as flax moves them: ``running = 0.9·running +
    0.1·batch``. torch's ``F.batch_norm`` would move ``running_var`` by the
    unbiased variance, so the train path is written here: the kernels of
    ``ops/batch_norm.py`` on a card (statistics, normalization, residual and
    ReLU in two launches forward and two backward), their plain twin on the
    CPU. The variance is Welford's or the mean of (x − mean)²; flax takes it
    as E[x²] − E[x]², which cancels in float32 where a channel's mean dwarfs
    its spread and then moves the gradients by up to several % of a leaf's
    largest entry (tests/test_torch_train_east.py).

    With a process ``group`` (``sync_batch_stats``; data-parallel training)
    the statistics are those of the global batch, as under the JAX
    package's GSPMD: composed ops with two differentiable all-reduces, first
    of the per-channel sums and the element count, then of the sums of
    (x − mean)²."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.update_stats = True
        self.group = None
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, residual: Optional[torch.Tensor] = None, relu: bool = False):
        if self.training and self.group is None:
            return batch_norm(x, residual, self.weight, self.bias, self.running_mean,
                              self.running_var, self.update_stats, self.momentum, self.eps, relu)
        if self.training:
            y = self._global_batch(x)
        else:
            y = F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                False, 0.0, self.eps,
            )
        if residual is not None:
            y = y + residual
        if not relu:
            return y
        return F.relu(y) if self.training else F.relu(y, inplace=True)

    def _global_batch(self, x):
        """BN(x) with the statistics of the global batch over ``group``."""
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = float32_or_wider(x)
        count = torch.full((1,), xf.numel() // xf.shape[1], dtype=xf.dtype, device=xf.device)
        sums = sum_over_ranks(torch.cat([xf.sum(dims), count]), self.group)
        mean = sums[:-1] / sums[-1]
        xc = xf - mean.view(shape)
        var = sum_over_ranks(xc.square().sum(dims), self.group) / sums[-1]
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = xc * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


def float32_or_wider(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is when it is float64 (a model cast to
    float64 computes in float64 throughout)."""
    return x if x.dtype == torch.float64 else x.float()


@contextmanager
def frozen_batch_stats(model: nn.Module):
    """Inside: train-mode BatchNorms normalize with batch statistics but leave
    their running statistics alone."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    saved = [m.update_stats for m in bns]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m, s in zip(bns, saved):
            m.update_stats = s


def sync_batch_stats(model: nn.Module, group) -> None:
    """Every ``BatchNorm`` of ``model`` takes its train-mode statistics over
    the ranks of ``group`` (None: over its own batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


_DRAWS = threading.local()


@contextmanager
def global_draws(rank: int, world: int):
    """Inside: each random draw of a training forward (``rand_rows``) is
    made for a global batch of ``world`` equal slices and cut to slice
    ``rank``, this process's rows. With one generator seed on every rank,
    each row then gets the draw one device makes for it on the whole batch."""
    saved = getattr(_DRAWS, "slice", None)
    _DRAWS.slice = (rank, world)
    try:
        yield
    finally:
        _DRAWS.slice = saved


def rand_rows(shape: Sequence[int], generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """``torch.rand(shape)`` of a batch whose leading axis is the rows,
    drawn for the global batch inside ``global_draws``."""
    rank, world = getattr(_DRAWS, "slice", None) or (0, 1)
    if world == 1:
        return torch.rand(tuple(shape), generator=generator, device=device)
    b = shape[0]
    full = torch.rand((b * world, *shape[1:]), generator=generator, device=device)
    return full[rank * b:(rank + 1) * b]


def dropout(
    x: torch.Tensor,
    p: float,
    generator: Optional[torch.Generator] = None,
    mask_shape: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each entry with probability 1 − p (a uniform
    draw below 1 − p) and scale the kept ones by 1/(1 − p). ``mask_shape``
    broadcasts one draw over the axes where it is 1."""
    if p <= 0.0:
        return x
    keep = 1.0 - p
    shape = tuple(mask_shape) if mask_shape is not None else x.shape
    mask = rand_rows(shape, generator, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def conv(cin: int, cout: int, k, stride=1, padding=0, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias)
