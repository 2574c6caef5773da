"""Plain reference of EAST's training step, in torch operations.

Written from the recipe (olegiy/manuscript-ocr v0.1.8's EAST trainer as the
port documents it): a ResNet-50/101 feature extractor (7×7/2 stem, 3×3/2 max
pool, bottleneck stages at strides 4/8/16/32), the merge decoder (2×
bilinear upsample, concatenation, 1×1 and 3×3 convolutions with bias, each
followed by BatchNorm and ReLU), a sigmoid score head and an 8-channel QUAD
geometry head at a quarter of the input. BatchNorm normalises with the
batch's statistics (biased variance, ε 1e-5), as in training.

The loss: dice on the score map plus the L1 of the geometry summed over its
8 channels, weighted by the focal factor (1 − e^{−L})^γ, masked by the
ground-truth score and reduced by OHEM (the mean over images of each image's
top-k mean, k = ratio · pixels); predicted maps of another size than the
labels are first resized to them (bilinear, antialiased). The step: ASAM
(ε = ρ·p²·g / (‖|p|·g‖ + 1e-12) over every parameter, the gradient taken at
p + ε and applied at p), a zero gradient when the loss is not finite, the
global-norm clip over the trainable parameters, SGD with momentum
(t ← g + μ·t, p ← p − lr·t), and cosine warm restarts read at the update's
count before it increments, in float32.

It works on a dict of weights named as the port's ``EASTModel.state_dict()``
names them, in their own type (float32, or float64 for a witness of
rounding), and imports nothing of the port.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..counts import RESNET_BLOCKS, RESNET_STEM

W = Dict[str, torch.Tensor]


def layout(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of every weight of the configuration."""
    backbone = cfg["backbone"]
    out: Dict[str, Tuple[int, ...]] = {}

    def conv(name, cin, cout, k, bias=False):
        out[f"{name}.weight"] = (cout, cin, k, k)
        if bias:
            out[f"{name}.bias"] = (cout,)

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{leaf}"] = (c,)

    width = RESNET_STEM.get(backbone, 64)
    conv("backbone.conv1", 3, width, 7); bn("backbone.bn1", width)
    cin, planes, chans = width, width, []
    for stage, n in enumerate(RESNET_BLOCKS[backbone]):
        for b in range(n):
            p = f"backbone.layer{stage + 1}_{b}"
            conv(f"{p}.conv1", cin, planes, 1); bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2", planes, planes, 3); bn(f"{p}.bn2", planes)
            conv(f"{p}.conv3", planes, 4 * planes, 1); bn(f"{p}.bn3", 4 * planes)
            if b == 0:
                conv(f"{p}.down_conv", cin, 4 * planes, 1); bn(f"{p}.down_bn", 4 * planes)
            cin = 4 * planes
        chans.append(cin)
        planes *= 2
    for i, (cin_, mid, cout) in enumerate(_decoder_plan(backbone, chans), 1):
        p = f"decoder.block{i}"
        conv(f"{p}.conv1x1", cin_, mid, 1, True); bn(f"{p}.bn1", mid)
        conv(f"{p}.conv3x3", mid, cout, 3, True); bn(f"{p}.bn2", cout)
    last = _decoder_plan(backbone, chans)[-1][2]
    conv("score_head", last, 1, 1, True)
    conv("geo_head", last, 8, 1, True)
    return out


def _decoder_plan(backbone: str, chans: Sequence[int]) -> List[Tuple[int, int, int]]:
    mult = 0.25 if backbone.endswith("-micro") else 1.0
    c = lambda n: max(8, int(n * mult))
    r1, r2, r3, r4 = chans
    return [(r4, c(512), c(512)), (c(512) + r3, c(256), c(256)),
            (c(256) + r2, c(128), c(128)), (c(128) + r1, c(64), c(32))]


def _bn(w: W, name: str, x):
    return F.batch_norm(x, None, None, w[f"{name}.weight"], w[f"{name}.bias"], True, 0.0, 1e-5)


def _widen(x: torch.Tensor) -> torch.Tensor:
    """Heads under autocast come out in 16 bits: the loss takes float32."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def forward(w: W, cfg: Dict, image_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, S, 3) uint8 → (score (B, S/4, S/4), geometry (B, S/4, S/4, 8))."""
    x = ((image_u8.to(w["backbone.conv1.weight"].dtype) / 255.0 - 0.5) / 0.5).permute(0, 3, 1, 2)
    x = F.relu(_bn(w, "backbone.bn1", F.conv2d(x, w["backbone.conv1.weight"], stride=2, padding=3)))
    x = F.max_pool2d(x, 3, 2, padding=1)
    feats = []
    for stage, n in enumerate(RESNET_BLOCKS[cfg["backbone"]]):
        for b in range(n):
            p = f"backbone.layer{stage + 1}_{b}"
            st = (1 if stage == 0 else 2) if b == 0 else 1
            out = F.relu(_bn(w, f"{p}.bn1", F.conv2d(x, w[f"{p}.conv1.weight"])))
            out = F.relu(_bn(w, f"{p}.bn2", F.conv2d(out, w[f"{p}.conv2.weight"], stride=st, padding=1)))
            out = _bn(w, f"{p}.bn3", F.conv2d(out, w[f"{p}.conv3.weight"]))
            idt = _bn(w, f"{p}.down_bn", F.conv2d(x, w[f"{p}.down_conv.weight"], stride=st)) if b == 0 else x
            x = F.relu(out + idt)
        feats.append(x)
    h = None
    for i, f in enumerate(reversed(feats), 1):
        if h is not None:
            h = F.interpolate(h, scale_factor=2, mode="bilinear", align_corners=False)
            f = torch.cat([h, f], 1)
        p = f"decoder.block{i}"
        h = F.relu(_bn(w, f"{p}.bn1", F.conv2d(f, w[f"{p}.conv1x1.weight"], w[f"{p}.conv1x1.bias"])))
        h = F.relu(_bn(w, f"{p}.bn2", F.conv2d(h, w[f"{p}.conv3x3.weight"], w[f"{p}.conv3x3.bias"], padding=1)))
    score = torch.sigmoid(_widen(F.conv2d(h, w["score_head.weight"], w["score_head.bias"])))[:, 0]
    geo = _widen(F.conv2d(h, w["geo_head.weight"], w["geo_head.bias"])).permute(0, 2, 3, 1)
    return score, geo


def loss(w: W, cfg: Dict, image_u8, gt_score, gt_geo) -> torch.Tensor:
    score, geo = forward(w, cfg, image_u8)
    gh, gw = gt_score.shape[1:3]
    if score.shape[1:3] != (gh, gw):
        resize = lambda t: F.interpolate(t, size=(gh, gw), mode="bilinear", align_corners=False,
                                         antialias=True)
        score = resize(score[:, None])[:, 0]
        geo = resize(geo.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    n_pos = gt_score.sum()
    dice = 1.0 - 2.0 * (gt_score * score).sum() / (n_pos + score.sum() + 1e-5)
    l1 = (gt_geo - geo).abs().sum(-1)
    if cfg["use_focal_geo"]:
        l1 = l1 * (1.0 - torch.exp(-l1)) ** cfg["focal_gamma"]
    l1 = (l1 * gt_score).reshape(l1.shape[0], -1)
    if cfg["use_ohem"]:
        k = max(int(cfg["ohem_ratio"] * l1.shape[1]), 1)
        geo_loss = l1.topk(k, dim=1).values.mean(1).sum() / l1.shape[0]
    else:
        geo_loss = l1.sum() / (n_pos + 1e-5)
    total = dice + geo_loss
    return torch.where(n_pos < 1.0, 0.0 * total, total)


def learning_rate(cfg: Dict, count: int, steps_per_epoch: int) -> float:
    """Cosine warm restarts of t_0 epochs, read at ``count``, in float32."""
    f32 = np.float32
    length = max(cfg["t_0"] * steps_per_epoch, 1)
    c = f32(count % length) if count < 16 * length else f32(length)
    cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(length)))
    a = cfg["eta_min_ratio"]
    return float(f32(cfg["lr"]) * (f32(1 - a) * cos + f32(a)))


class Trainer:
    """The reference's training state: weights, momentum trace, count; from
    the start (no trace, count 0), or from a given ``trace`` and ``count``."""

    def __init__(self, cfg: Dict, weights: W, trainable: Sequence[str], steps_per_epoch: int,
                 trace: Optional[W] = None, count: int = 0):
        self.cfg = cfg
        self.params = {k: v.detach().clone().requires_grad_(not k.endswith(("running_mean", "running_var")))
                       for k, v in weights.items()}
        self.trainable = list(trainable)
        self.trace = {k: (torch.zeros_like(self.params[k]) if trace is None
                          else trace[k].detach().to(self.params[k].dtype, copy=True))
                      for k in self.trainable}
        self.count = count
        self.steps_per_epoch = steps_per_epoch
        self.gradient: Optional[Dict[str, torch.Tensor]] = None  # the last step's, clipped, trainable
        self.first_gradient: Optional[Dict[str, torch.Tensor]] = None  # clipped, trainable
        self.first_gradient_all: Optional[Dict[str, torch.Tensor]] = None  # every parameter
        self.losses: List[float] = []

    def step(self, image, score, geo) -> float:
        cfg = self.cfg
        names = [k for k, p in self.params.items() if p.requires_grad]
        ps = [self.params[k] for k in names]
        g1 = torch.autograd.grad(loss(self.params, cfg, image, score, geo), ps)
        with torch.no_grad():
            saved = [p.detach().clone() for p in ps]
            if cfg["sam_type"] == "asam":
                norm = torch.sqrt(sum(((p.abs() * g) ** 2).sum() for p, g in zip(ps, g1)))
                e_w = [p * p * g * (cfg["sam_rho"] / (norm + 1e-12)) for p, g in zip(ps, g1)]
            else:
                norm = torch.sqrt(sum((g ** 2).sum() for g in g1))
                e_w = [g * (cfg["sam_rho"] / (norm + 1e-12)) for g in g1]
            for p, e in zip(ps, e_w):
                p.add_(e)
        l2 = loss(self.params, cfg, image, score, geo)
        g2 = dict(zip(names, torch.autograd.grad(l2, ps)))
        with torch.no_grad():
            for p, orig in zip(ps, saved):
                p.copy_(orig)
            finite = torch.isfinite(l2)
            g2 = {k: torch.where(finite, t, torch.zeros_like(t)) for k, t in g2.items()}
            if self.first_gradient_all is None:
                self.first_gradient_all = {k: t.clone() for k, t in g2.items()}
            g = {k: g2[k] for k in self.trainable}
            norm = torch.sqrt(sum((t ** 2).sum() for t in g.values()))
            if norm >= cfg["grad_clip"]:
                g = {k: t / norm * cfg["grad_clip"] for k, t in g.items()}
            self.gradient = {k: t.clone() for k, t in g.items()}
            if self.first_gradient is None:
                self.first_gradient = self.gradient
            lr = learning_rate(cfg, self.count, self.steps_per_epoch)
            for k in self.trainable:
                self.trace[k] = g[k] + cfg["momentum"] * self.trace[k]
                self.params[k].sub_(lr * self.trace[k])
            self.count += 1
        self.losses.append(float(l2.detach()))
        return self.losses[-1]

    def parameters(self) -> W:
        return {k: p.detach() for k, p in self.params.items() if p.requires_grad}
