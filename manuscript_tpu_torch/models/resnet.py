"""ResNet-50/101 feature extractor (counterpart of ``manuscript_tpu/models/resnet.py``).

Stem 7×7/2 conv (pad 3) + BN + ReLU + 3×3/2 max pool (−inf pad), then four
bottleneck stages at strides 4/8/16/32, features returned after each. The
JAX package computes the stem as a space-to-depth 4×4 conv over the same
(7, 7, C_in, width) kernel, a TPU layout trick with the same result; here it
is the plain 7×7/2 conv. NCHW inside; ``forward`` takes NCHW. Train mode is
the module's (``model.train()``): its BatchNorms then use and update batch
statistics.
"""

from __future__ import annotations

from typing import Dict

import torch.nn.functional as F
from torch import Tensor, nn

from .layers import BatchNorm, conv

STAGE_BLOCKS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet50-tiny": (1, 1, 1, 1),
    "resnet50-micro": (1, 1, 1, 1),
}
STEM_WIDTH = {"resnet50-micro": 16}  # default 64


class Bottleneck(nn.Module):
    """1×1 reduce → 3×3 (stride) → 1×1 expand(×4), residual add."""

    def __init__(self, cin: int, planes: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1 = conv(cin, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv(planes, planes, 3, stride, 1)
        self.bn2 = BatchNorm(planes)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = downsample
        if downsample:
            self.down_conv = conv(cin, planes * 4, 1, stride)
            self.down_bn = BatchNorm(planes * 4)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.down_bn(self.down_conv(x)) if self.downsample else x
        return F.relu(out + identity)


class ResNetFeatures(nn.Module):
    """Stage outputs res1 (/4) … res4 (/32)."""

    def __init__(self, backbone: str = "resnet50"):
        super().__init__()
        width = STEM_WIDTH.get(backbone, 64)
        self.conv1 = conv(3, width, 7, 2, 3)
        self.bn1 = BatchNorm(width)
        self.names = []
        cin, planes = width, width
        for stage, n_blocks in enumerate(STAGE_BLOCKS[backbone]):
            for b in range(n_blocks):
                name = f"layer{stage + 1}_{b}"
                stride = (1 if stage == 0 else 2) if b == 0 else 1
                self.add_module(name, Bottleneck(cin, planes, stride, b == 0))
                self.names.append((stage, name))
                cin = planes * 4
            planes *= 2

    def forward(self, x: Tensor) -> Dict[str, Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        feats = {}
        for stage, name in self.names:
            x = getattr(self, name)(x)
            feats[f"res{stage + 1}"] = x
        return feats
