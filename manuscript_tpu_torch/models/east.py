"""EAST detection network (counterpart of ``manuscript_tpu/models/east.py``).

ResNet backbone taps at strides 4/8/16/32, a merge decoder (2× bilinear
upsample, half-pixel centres, + concat + conv1×1/BN/ReLU + conv3×3/BN/ReLU)
and 1×1 heads: a sigmoid score map (1 channel) and QUAD geometry
(8 channels) at 1/4 resolution, both float32 whatever the compute dtype.
``forward`` keeps the JAX layout: NHWC in, NHWC out. In train mode
(``model.train()``) every BatchNorm uses and updates batch statistics, as
flax's ``train=True`` does.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, conv
from .resnet import STEM_WIDTH, ResNetFeatures


class DecoderBlock(nn.Module):
    """conv1×1+BN+ReLU → conv3×3+BN+ReLU (both convs with bias)."""

    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self.conv1x1 = conv(cin, mid, 1, bias=True)
        self.bn1 = BatchNorm(mid)
        self.conv3x3 = conv(mid, cout, 3, 1, 1, bias=True)
        self.bn2 = BatchNorm(cout)

    def forward(self, x):
        x = self.bn1(self.conv1x1(x), relu=True)
        return self.bn2(self.conv3x3(x), relu=True)


def upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class MergeDecoder(nn.Module):
    """Top-down merging res4 → … → res1; ``width_mult`` narrows the plan."""

    def __init__(self, stage_channels, width_mult: float = 1.0):
        super().__init__()
        c = lambda n: max(8, int(n * width_mult))
        r1, r2, r3, r4 = stage_channels
        self.block1 = DecoderBlock(r4, c(512), c(512))
        self.block2 = DecoderBlock(c(512) + r3, c(256), c(256))
        self.block3 = DecoderBlock(c(256) + r2, c(128), c(128))
        self.block4 = DecoderBlock(c(128) + r1, c(64), c(32))
        self.out_channels = c(32)

    def forward(self, feats):
        h4 = self.block1(feats["res4"])
        h3 = self.block2(torch.cat([upsample2x(h4), feats["res3"]], dim=1))
        h2 = self.block3(torch.cat([upsample2x(h3), feats["res2"]], dim=1))
        return self.block4(torch.cat([upsample2x(h2), feats["res1"]], dim=1))


class EASTModel(nn.Module):
    def __init__(self, backbone: str = "resnet50"):
        super().__init__()
        width = STEM_WIDTH.get(backbone, 64)
        self.backbone = ResNetFeatures(backbone)
        mult = 0.25 if backbone.endswith("-micro") else 1.0
        self.decoder = MergeDecoder([width * 4 * 2**i for i in range(4)], mult)
        self.score_head = conv(self.decoder.out_channels, 1, 1, bias=True)
        self.geo_head = conv(self.decoder.out_channels, 8, 1, bias=True)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, 3) normalized, in the model's dtype →
        {"score": (B, H/4, W/4, 1), "geometry": (B, H/4, W/4, 8)} float32."""
        merged = self.decoder(self.backbone(x.permute(0, 3, 1, 2)))
        score = torch.sigmoid(self.score_head(merged).float())
        geometry = self.geo_head(merged).float()
        return {
            "score": score.permute(0, 2, 3, 1),
            "geometry": geometry.permute(0, 2, 3, 1),
        }
