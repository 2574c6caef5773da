"""``utils.weights.init_random_`` draws flax's default kernel init,
``nn.initializers.lecun_normal()``: a standard normal truncated at ±2,
divided by its std 0.87962566, times 1/√fan_in.

For a conv (256 out, 128 in, 3×3: fan_in 1152) and a dense kernel (512 in,
1024 out: fan_in 512), against ``jax.nn.initializers.lecun_normal()``'s
draws of the same shape:

* no sample beyond 2/0.87962566 = 2.2737 over √fan_in;
* the std within 2 % of 1/√fan_in (the draws' own spread is ~0.1 %);
* the two-sample Kolmogorov–Smirnov statistic under 1.95·√((n + m)/(n·m)),
  its critical value at the 0.1 % level.

The plain normal of the same variance, which the port drew before, fails
the tail bound and the KS bound (the two laws' CDFs part by 0.0167, three
times the critical value at these sizes).
"""

import jax
import numpy as np
import pytest
import torch
from torch import nn

from manuscript_tpu_torch.models.east import EASTModel
from manuscript_tpu_torch.utils.weights import TRUNCATED_STD, init_random_

SHAPES = {  # name → (torch module, the flax kernel's shape, fan_in)
    "conv": (lambda: nn.Conv2d(128, 256, 3, bias=False), (3, 3, 128, 256), 1152),
    "dense": (lambda: nn.Linear(512, 1024, bias=False), (512, 1024), 512),
}
KS_C = 1.95  # the two-sample KS critical value's coefficient at the 0.1 % level
STD_REL = 0.02


def ks_statistic(a: np.ndarray, b: np.ndarray) -> float:
    """sup |F_a − F_b| of the two samples' empirical CDFs."""
    a, b = np.sort(a), np.sort(b)
    grid = np.concatenate([a, b])
    fa = np.searchsorted(a, grid, side="right") / a.size
    fb = np.searchsorted(b, grid, side="right") / b.size
    return float(np.abs(fa - fb).max())


def fails(draws: np.ndarray, reference: np.ndarray, fan_in: int) -> list:
    """The checks of the module docstring that ``draws`` fail."""
    scaled = draws * np.sqrt(fan_in)
    n, m = draws.size, reference.size
    out = []
    if np.abs(scaled).max() > 2 / TRUNCATED_STD:
        out.append("tail")
    if abs(scaled.std() - 1) > STD_REL:
        out.append("std")
    if ks_statistic(draws, reference) > KS_C * np.sqrt((n + m) / (n * m)):
        out.append("ks")
    return out


def jax_draws(shape) -> np.ndarray:
    return np.asarray(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(1), shape)).ravel()


@pytest.mark.parametrize("name", SHAPES)
def test_init_random_draws_flax_lecun_normal(name):
    module, flax_shape, fan_in = SHAPES[name]
    draws = init_random_(module(), seed=0).weight.detach().numpy().ravel()
    assert fails(draws, jax_draws(flax_shape), fan_in) == []


@pytest.mark.parametrize("name", SHAPES)
def test_the_checks_fail_the_plain_normal(name):
    module, flax_shape, fan_in = SHAPES[name]
    shape = module().weight.shape
    plain = (torch.randn(shape, generator=torch.Generator().manual_seed(0)) / np.sqrt(fan_in))
    assert fails(plain.numpy().ravel(), jax_draws(flax_shape), fan_in) == ["tail", "ks"]


def test_every_kernel_of_a_model_lies_within_the_truncation():
    """Every conv of the micro EAST within 2.2737/√fan_in, the BatchNorms the
    identity; the same seed draws the same weights, another seed others."""
    state = init_random_(EASTModel("resnet50-micro"), seed=3).state_dict()
    for name, t in state.items():
        if t.dim() == 4:
            fan_in = int(np.prod(t.shape[1:]))
            assert t.abs().max().item() * np.sqrt(fan_in) <= 2 / TRUNCATED_STD, name
        elif name.endswith("running_var"):
            assert torch.equal(t, torch.ones_like(t))
    again = init_random_(EASTModel("resnet50-micro"), seed=3).state_dict()
    other = init_random_(EASTModel("resnet50-micro"), seed=4).state_dict()
    conv = "backbone.conv1.weight"
    assert torch.equal(state[conv], again[conv]) and not torch.equal(state[conv], other[conv])
