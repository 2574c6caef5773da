"""Plain reference of the TRBA trainer's step, in torch operations.

Written from the recipe (olegiy/manuscript-ocr v0.1.8's TRBA trainer as the
port documents it): the network of ``reference/trba.py`` in train mode —
BatchNorm normalising with the batch's mean and biased variance (ε 1e-5),
the encoder's output through dropout, and the decoder's attention weights
through dropout at each teacher-forced step (keep a value when its uniform
draw lies below 1 − p, scale the kept ones by 1/(1 − p)) — the
cross-entropy over the steps whose target is not PAD, the gradient zeroed
when the loss is not finite, the global-norm clip, and Adam (β 0.9, 0.999,
ε 1e-8, bias corrections 1 − β^count in float32) at a constant learning
rate.

The dropout masks are the program's: each step draws them from a
``torch.Generator`` in the state the program's step began with, in the
program's order and shapes (the encoder's output (B, T, hidden), then each
decoder step's attention weights (B, T, 1)). It works on a dict of weights
named as the port's ``TRBAModel.state_dict()`` names them, computes in
their dtype, and imports nothing of the port.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..counts import SERESNET31_PLANS, SERESNET31_STEM
from .trba import _bilstm

W = Dict[str, torch.Tensor]


def _bn(w: W, name: str, x):
    """Train-mode BatchNorm: the batch's mean and biased variance."""
    dims = [0] + list(range(2, x.dim()))
    mean = x.mean(dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dims, keepdim=True)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mean) * torch.rsqrt(var + 1e-5) * w[f"{name}.weight"].view(shape) + w[f"{name}.bias"].view(shape)


def _block(w: W, p: str, x, stride: int, down: bool):
    out = F.relu(_bn(w, f"{p}.bn1", F.conv2d(x, w[f"{p}.conv1.weight"], stride=stride, padding=1)))
    out = _bn(w, f"{p}.bn2", F.conv2d(out, w[f"{p}.conv2.weight"], padding=1))
    se = torch.sigmoid(F.relu(out.mean(dim=(2, 3)) @ w[f"{p}.se.fc1.weight"].T)
                       @ w[f"{p}.se.fc2.weight"].T)
    out = out * se[:, :, None, None]
    idt = _bn(w, f"{p}.down_bn", F.conv2d(x, w[f"{p}.down_conv.weight"], stride=stride)) if down else x
    return F.relu(out + idt)


def _dropout(x, p: float, gen: torch.Generator):
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def encode(w: W, cfg: Dict, strips_u8: torch.Tensor, gen: torch.Generator, p: float) -> torch.Tensor:
    """(B, H, W, 3) uint8 strips → the encoder's output (B, T, hidden) in
    train mode, through dropout ``p``."""
    x = ((strips_u8.to(w["cnn.stem_conv1.weight"].dtype) / 255.0 - 0.5) / 0.5).permute(0, 3, 1, 2)
    x = F.relu(_bn(w, "cnn.stem_bn1", F.conv2d(x, w["cnn.stem_conv1.weight"], padding=1)))
    x = F.relu(_bn(w, "cnn.stem_bn2", F.conv2d(x, w["cnn.stem_conv2.weight"], padding=1)))
    x = F.max_pool2d(x, 2, 2)
    plan = cfg["cnn_stage_plan"]
    cin = SERESNET31_STEM.get(plan, (64, 128))[1]
    for stage, (planes, blocks, stride) in enumerate(SERESNET31_PLANS[plan], 1):
        for b in range(blocks):
            st = stride if b == 0 else 1
            x = _block(w, f"cnn.layer{stage}_{b}", x, st, b == 0 and (st != 1 or cin != planes))
            cin = planes
    x = F.relu(_bn(w, "cnn.out_bn1", F.conv2d(x, w["cnn.out_conv1.weight"], stride=(2, 1), padding=(0, 1))))
    x = F.relu(_bn(w, "cnn.out_bn2", F.conv2d(x, w["cnn.out_conv2.weight"])))
    f = _bilstm(w, "enc_rnn2", _bilstm(w, "enc_rnn1", x.mean(dim=2).transpose(1, 2)))
    return _dropout(f, p, gen)


def forced_logits(w: W, enc, text_in, gen: torch.Generator, p: float):
    """Teacher-forced logits (B, steps, V) along ``text_in`` (SOS first),
    the attention weights of each step through dropout ``p``."""
    d = "decoder"
    b, steps = text_in.shape
    hid = w[f"{d}.h2h_kernel"].shape[0]
    e_dim = enc.shape[2]
    proj_enc = enc @ w[f"{d}.i2h_kernel"]
    h = enc.new_zeros(b, hid)
    c = enc.new_zeros(b, hid)
    k_ih = w[f"{d}.lstm_kernel_ih"]
    hs = []
    for t in range(steps):
        e = torch.tanh(proj_enc + (h @ w[f"{d}.h2h_kernel"] + w[f"{d}.h2h_bias"])[:, None, :]) \
            @ w[f"{d}.score_kernel"]
        alpha = _dropout(torch.softmax(e, dim=1), p, gen)
        ctx = (alpha * enc).sum(1)
        z = ctx @ k_ih[:e_dim] + k_ih[e_dim + text_in[:, t].long()] + h @ w[f"{d}.lstm_kernel_hh"] \
            + w[f"{d}.lstm_bias"]
        i, f, g, o = z.split(hid, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, 1) @ w[f"{d}.gen_kernel"] + w[f"{d}.gen_bias"]


def loss(w: W, cfg: Dict, batch: Dict[str, torch.Tensor], gen: torch.Generator) -> torch.Tensor:
    """The mean cross-entropy over the steps whose target is not PAD."""
    p = cfg["dropout"]
    logits = forced_logits(w, encode(w, cfg, batch["image"], gen, p), batch["text_in"], gen, p)
    target = batch["target_y"].long()
    mask = (target != cfg["pad_id"]).to(logits.dtype)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), target.reshape(-1), reduction="none")
    return (ce.reshape(target.shape) * mask).sum() / mask.sum().clamp_min(1.0)


def _f32_correction(decay: float, count: int) -> float:
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class Trainer:
    """The reference's steps from ``weights`` (every parameter trained; the
    running statistics are left out: no checked number reads them).
    ``losses`` each step's loss, ``first_gradient`` the first step's
    gradient after the clip, ``params`` the weights now."""

    def __init__(self, cfg: Dict, weights: W, trainable: List[str]):
        self.cfg = cfg
        self.params = {k: weights[k].detach().clone().requires_grad_(True) for k in trainable}
        self.frozen = {k: v for k, v in weights.items() if k not in self.params}
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0
        self.losses: List[float] = []
        self.first_gradient = None

    def step(self, batch: Dict[str, torch.Tensor], gen_state: torch.Tensor) -> None:
        cfg = self.cfg
        gen = torch.Generator(device=batch["image"].device)
        gen.set_state(gen_state)
        value = loss({**self.frozen, **self.params}, cfg, batch, gen)
        grads = torch.autograd.grad(value, list(self.params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(self.params.items(), grads)}
        if not torch.isfinite(value):
            grads = {k: torch.zeros_like(g) for k, g in grads.items()}
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values())).float()
        if not norm < cfg["grad_clip"]:
            grads = {k: g / norm * cfg["grad_clip"] for k, g in grads.items()}
        if self.first_gradient is None:
            self.first_gradient = {k: g.detach().clone() for k, g in grads.items()}
        self.count += 1
        c1, c2 = _f32_correction(0.9, self.count), _f32_correction(0.999, self.count)
        with torch.no_grad():
            for k, p in self.params.items():
                self.mu[k] = 0.1 * grads[k] + 0.9 * self.mu[k]
                self.nu[k] = 0.001 * grads[k] ** 2 + 0.999 * self.nu[k]
                p -= cfg["lr"] * (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + 1e-8)
        self.losses.append(float(value.detach()))
