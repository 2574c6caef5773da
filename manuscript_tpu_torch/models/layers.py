"""Small layers shared by the port's networks (NCHW inside a network)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """Inference-mode BatchNorm over channel dim 1 (flax ``nn.BatchNorm`` with
    ``use_running_average=True``, epsilon 1e-5). Its state is buffers:
    weight, bias, running_mean, running_var."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias,
            False, 0.0, self.eps,
        )


def conv(cin: int, cout: int, k, stride=1, padding=0, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias)
