"""SEResNet31 recognizer backbone (counterpart of
``manuscript_tpu/models/seresnet31.py``): stem 3→64→128 + 2×2 max pool,
SE basic-block stages, then ``out_conv1`` (2×2, stride (2,1), padding (0,1))
and a valid 2×2 ``out_conv2``. NCHW inside; ``forward`` takes NCHW.

In train mode (``model.train()``) the BatchNorms use and update batch
statistics and, when ``dropblock_p`` > 0, each block drops whole channels of
a sample after its SE layer (flax ``nn.Dropout`` with ``broadcast_dims=(1,
2)``: one draw per sample and channel), scaling the kept ones by 1/(1 − p).
The draws come from the ``generator`` given to ``forward``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, conv, dropout

# (planes, blocks, stride) per stage
STAGE_PLANS = {
    "full": ((256, 1, 2), (256, 2, 1), (512, 5, 2), (512, 3, 1)),
    "tiny": ((256, 1, 2), (256, 1, 1), (512, 1, 2), (512, 1, 1)),
    "micro": ((64, 1, 2), (64, 1, 1), (128, 1, 2), (128, 1, 1)),
}
STEM_WIDTHS = {"micro": (32, 64)}  # default (64, 128)


class SELayer(nn.Module):
    """Squeeze-Excitation: global mean → FC reduce → ReLU → FC → sigmoid."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // reduction, bias=False)
        self.fc2 = nn.Linear(channels // reduction, channels, bias=False)

    def forward(self, x):
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3))))))
        return x * y[:, :, None, None]


class SEBasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, downsample: bool,
                 dropblock_p: float = 0.0):
        super().__init__()
        self.conv1 = conv(cin, planes, 3, stride, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm(planes)
        self.se = SELayer(planes)
        self.dropblock_p = dropblock_p
        self.downsample = downsample
        if downsample:
            self.down_conv = conv(cin, planes, 1, stride)
            self.down_bn = BatchNorm(planes)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        out = self.bn1(self.conv1(x), relu=True)
        out = self.se(self.bn2(self.conv2(out)))
        if self.training and self.dropblock_p > 0:
            out = dropout(out, self.dropblock_p, generator, (*out.shape[:2], 1, 1))
        identity = self.down_bn(self.down_conv(x)) if self.downsample else x
        return F.relu(out + identity)


class SEResNet31(nn.Module):
    def __init__(self, out_channels: int = 512, stage_plan: str = "full",
                 dropblock_p: float = 0.0):
        super().__init__()
        stem1, stem2 = STEM_WIDTHS.get(stage_plan, (64, 128))
        self.stem_conv1 = conv(3, stem1, 3, 1, 1)
        self.stem_bn1 = BatchNorm(stem1)
        self.stem_conv2 = conv(stem1, stem2, 3, 1, 1)
        self.stem_bn2 = BatchNorm(stem2)
        self.names = []
        cin = stem2
        for stage, (planes, blocks, stride) in enumerate(STAGE_PLANS[stage_plan], 1):
            for b in range(blocks):
                name = f"layer{stage}_{b}"
                down = b == 0 and (stride != 1 or cin != planes)
                self.add_module(
                    name,
                    SEBasicBlock(cin, planes, stride if b == 0 else 1, down, dropblock_p),
                )
                self.names.append(name)
                cin = planes
        self.out_conv1 = conv(cin, out_channels, 2, (2, 1), (0, 1))
        self.out_bn1 = BatchNorm(out_channels)
        self.out_conv2 = conv(out_channels, out_channels, 2)
        self.out_bn2 = BatchNorm(out_channels)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.stem_bn1(self.stem_conv1(x), relu=True)
        x = self.stem_bn2(self.stem_conv2(x), relu=True)
        x = F.max_pool2d(x, 2, 2)
        for name in self.names:
            x = getattr(self, name)(x, generator)
        x = self.out_bn1(self.out_conv1(x), relu=True)
        x = self.out_bn2(self.out_conv2(x), relu=True)
        if x.shape[2] == 0 or x.shape[3] == 0:
            raise ValueError(
                f"input too small for SEResNet31: feature map {tuple(x.shape)}"
            )
        return x  # (B, C, H', W')
