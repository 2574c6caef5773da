"""Weights made on the device from the seed, in a few large calls.

Every leaf of a layout ({name: shape}) is drawn from one normal draw of a
``torch.Generator`` on the device: kernels as N(0, 1/fan_in) (a convolution's
or ``nn.Linear``'s ``weight`` in torch's (out, in, ...) layout, a flax-named
``*kernel*`` in its (in, out) layout), BatchNorm scales and running
variances as N(1, 0.1²), every other vector (biases, BatchNorm shifts and
running means) as N(0, 0.05²). No leaf is left at a constant, so a fault
that drops any parameter shows in the outputs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def _scale_offset(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) >= 2:
        fan_in = shape[0] if "kernel" in leaf else int(torch.Size(shape[1:]).numel())
        return fan_in ** -0.5, 0.0
    if leaf in ("running_var",) or (leaf == "weight" and len(shape) == 1):
        return 0.1, 1.0
    return 0.05, 0.0


def make_weights(layout: Dict[str, Tuple[int, ...]], seed: int, device,
                 dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """{name: tensor} for ``layout``, drawn from ``seed`` on ``device``."""
    names = sorted(layout)
    sizes = [int(torch.Size(layout[n]).numel()) for n in names]
    so = torch.tensor([_scale_offset(n, tuple(layout[n])) for n in names], dtype=torch.float32,
                      device=device)
    counts = torch.tensor(sizes, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    flat = flat * torch.repeat_interleave(so[:, 0], counts) + torch.repeat_interleave(so[:, 1], counts)
    flat = flat.to(dtype)
    return {n: t.view(layout[n]) for n, t in zip(names, torch.split(flat, sizes))}


def layout_of(module: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}
