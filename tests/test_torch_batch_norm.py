"""Train-mode BatchNorm (``ops/batch_norm.py``, ``BatchNorm.forward(x,
residual, relu)``) on the CPU, where it runs the kernels' plain twin:

* the twin's output, running statistics and gradients equal the composed
  autograd path the port ran before (mean, subtract, square, mean, rsqrt,
  multiply, add, then the residual add and the ReLU) in float64, for plain,
  ReLU and residual + ReLU, channels_last and row-major 4-D and 2-D, with
  and without the running update; ``gradcheck`` holds its backward;
* a channel whose mean is 1e4 times its spread keeps its variance in
  float32, which the E[x²] − E[x]² form does not;
* the ``group`` route is the composed code with its two all-reduces, and
  eval mode issues ``F.batch_norm``, the residual add and the ReLU (in
  place on the tensor it made) and leaves its input alone;
* the cut of ``plan`` for the cells' shapes covers every row, vector and
  channel once.

The kernels themselves are held to the twin on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from manuscript_tpu_torch.models import layers
from manuscript_tpu_torch.models.layers import BatchNorm, frozen_batch_stats
from manuscript_tpu_torch.ops import batch_norm as bn

SHAPES = {"channels_last": (3, 6, 5, 4), "row_major": (3, 6, 5, 4), "2d": (9, 6)}
MODES = {"plain": (False, False), "relu": (False, True), "residual_relu": (True, True)}


def composed(x, r, w, b, rm, rv, update, relu, momentum=0.9, eps=1e-5):
    """The composed train path: ``BatchNorm.forward``'s train branch before
    the kernels, then the call sites' residual add and ReLU."""
    dims = [0] + list(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    xf = x if x.dtype == torch.float64 else x.float()
    mean = xf.mean(dims)
    xc = xf - mean.view(shape)
    var = xc.square().mean(dims)
    if update:
        with torch.no_grad():
            rm.copy_(momentum * rm + (1 - momentum) * mean)
            rv.copy_(momentum * rv + (1 - momentum) * var)
    mul = torch.rsqrt(var + eps) * w
    y = (xc * mul.view(shape) + b.view(shape)).to(x.dtype)
    if r is not None:
        y = y + r
    return F.relu(y) if relu else y


def inputs(lay, mode, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    shape = SHAPES[lay]
    x = torch.randn(shape, generator=g, dtype=dtype) * 2 + 1
    if lay == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    r = None
    if MODES[mode][0]:
        r = (torch.randn(shape, generator=g, dtype=dtype)).contiguous(
            memory_format=torch.channels_last if lay == "channels_last" else torch.contiguous_format)
    c = shape[1]
    w = torch.rand(c, generator=g, dtype=dtype) + 0.5
    b = torch.randn(c, generator=g, dtype=dtype) * 0.3
    up = torch.randn(shape, generator=g, dtype=dtype)
    return x, r, w, b, up


@pytest.mark.parametrize("update", [True, False])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("lay", list(SHAPES))
def test_twin_equals_the_composed_path_in_float64(lay, mode, update):
    x, r, w, b, up = inputs(lay, mode)
    relu = MODES[mode][1]
    m = BatchNorm(x.shape[1]).double().train()
    m.update_stats = update
    with torch.no_grad():
        m.weight.copy_(w)
        m.bias.copy_(b)
        m.running_mean.uniform_(-1, 1)
    rm, rv = m.running_mean.clone(), m.running_var.clone()

    leaves = [x.clone().requires_grad_(), None if r is None else r.clone().requires_grad_()]
    before = bn.calls["twin"]
    got = m(leaves[0], residual=leaves[1], relu=relu)
    assert bn.calls["twin"] == before + 1
    assert got.stride() == x.stride()
    wanted = [x.clone().requires_grad_(), None if r is None else r.clone().requires_grad_(),
              w.clone().requires_grad_(), b.clone().requires_grad_()]
    want = composed(*wanted, rm, rv, update, relu)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    torch.testing.assert_close(m.running_mean, rm, rtol=0, atol=1e-14)
    torch.testing.assert_close(m.running_var, rv, rtol=0, atol=1e-14)

    ins = [t for t in leaves if t is not None] + [m.weight, m.bias]
    ref = [t for t in wanted if t is not None]
    for a, e in zip(torch.autograd.grad(got, ins, up), torch.autograd.grad(want, ref, up)):
        torch.testing.assert_close(a, e, rtol=0, atol=1e-11)

    args = [t.detach().clone().requires_grad_() for t in ins]
    with_r = r is not None

    def twin(*a):
        return bn.batch_norm(a[0], a[1] if with_r else None, a[-2], a[-1], rm.clone(),
                             rv.clone(), False, 0.9, 1e-5, relu)

    assert torch.autograd.gradcheck(twin, tuple(args))


# which of x, the residual and the per-channel vectors need a gradient
NEEDS = {"x": (True, False, False), "residual": (False, True, False),
         "weights": (False, False, True)}


@pytest.mark.parametrize("needs", list(NEEDS))
@pytest.mark.parametrize("lay", list(SHAPES))
def test_twin_gradients_when_only_some_inputs_need_them(lay, needs):
    """Residual + ReLU where only x, only the residual or only weight and
    bias need a gradient: the ReLU's mask is that of BN(x) + r whichever
    they are, so each wanted gradient equals the composed path's."""
    x, r, w, b, up = inputs(lay, "residual_relu")
    rm, rv = torch.zeros(x.shape[1], dtype=x.dtype), torch.ones(x.shape[1], dtype=x.dtype)
    flags = NEEDS[needs]
    ours = [x.clone().requires_grad_(flags[0]), r.clone().requires_grad_(flags[1]),
            w.clone().requires_grad_(flags[2]), b.clone().requires_grad_(flags[2])]
    theirs = [t.detach().clone().requires_grad_(t.requires_grad) for t in ours]
    got = bn.batch_norm(*ours, rm.clone(), rv.clone(), False, 0.9, 1e-5, True)
    want = composed(*theirs, rm.clone(), rv.clone(), False, True)
    wanted = [t for t in ours if t.requires_grad]
    for a, e in zip(torch.autograd.grad(got, wanted, up),
                    torch.autograd.grad(want, [t for t in theirs if t.requires_grad], up)):
        torch.testing.assert_close(a, e, rtol=0, atol=1e-11)


@pytest.mark.parametrize("lay", list(SHAPES))
def test_a_channel_far_from_zero_keeps_its_variance_in_float32(lay):
    """Mean 1e4 times the spread: the twin's (x − mean)² variance is within
    1e-4 of float64's; the E[x²] − E[x]² form is off by more than 10 %."""
    x, _, _, _, _ = inputs(lay, "plain", dtype=torch.float32, seed=3)
    x = x * 0.5 + 1e4
    dims = [0] + list(range(2, x.dim()))
    exact = x.double().var(dims, unbiased=False)
    m = BatchNorm(x.shape[1]).train()
    m.momentum = 0.0  # the running variance becomes the batch's
    m(x)
    np.testing.assert_allclose(m.running_var.double().numpy(), exact.numpy(), rtol=1e-4)
    cancelling = x.square().mean(dims) - x.mean(dims).square()
    assert float(((cancelling.double() - exact).abs() / exact).max()) > 0.1


def test_frozen_batch_stats_leave_the_running_statistics_to_the_twin():
    x, r, w, b, _ = inputs("channels_last", "residual_relu", dtype=torch.float32)
    m = BatchNorm(x.shape[1]).train()
    before = (m.running_mean.clone(), m.running_var.clone())
    with frozen_batch_stats(m):
        y = m(x, residual=r, relu=True)
    assert torch.equal(m.running_mean, before[0]) and torch.equal(m.running_var, before[1])
    m(x, residual=r, relu=True)
    assert not torch.equal(m.running_var, before[1])
    assert bool((y >= 0).all())


@pytest.mark.parametrize("mode", list(MODES))
def test_the_group_route_is_the_composed_code(monkeypatch, mode):
    """With a ``group`` the module takes the composed statistics through two
    all-reduces (here one rank's: the sums themselves) and not the twin."""
    seen = []

    def one_rank(t, group):
        seen.append(group)
        return t

    monkeypatch.setattr(layers, "sum_over_ranks", one_rank)
    x, r, w, b, _ = inputs("row_major", mode)
    relu = MODES[mode][1]
    m = BatchNorm(x.shape[1]).double().train()
    with torch.no_grad():
        m.weight.copy_(w)
        m.bias.copy_(b)
    m.group = group = object()
    rm, rv = m.running_mean.clone(), m.running_var.clone()
    before = dict(bn.calls)
    got = m(x, residual=r, relu=relu)
    assert seen == [group, group] and dict(bn.calls) == before
    torch.testing.assert_close(got, composed(x, r, w, b, rm, rv, True, relu), rtol=0, atol=1e-12)
    torch.testing.assert_close(m.running_var, rv, rtol=0, atol=1e-14)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode", list(MODES))
def test_eval_mode_issues_batch_norm_then_the_add_and_the_relu(mode):
    """Eval: ``F.batch_norm`` with the running statistics, then the residual
    add and the ReLU as ops of their own, as the call sites ran them; the
    ReLU in place on the tensor the module made (so the module's input,
    which its call holds, does not raise the peak), equal to the call
    sites' out-of-place ReLU, and the input and residual unchanged."""
    x, r, w, b, _ = inputs("channels_last", mode, dtype=torch.float32)
    relu = MODES[mode][1]
    m = BatchNorm(x.shape[1]).eval()
    with torch.no_grad():
        m.running_mean.uniform_(-1, 1)
    before = dict(bn.calls)
    with torch.no_grad(), _Ops() as got:
        y = m(x, residual=r, relu=relu)
    x0, r0 = x.clone(), None if r is None else r.clone()
    with torch.no_grad(), _Ops() as want:
        z = F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias, False, 0.0, m.eps)
        z = z + r if r is not None else z
        z = F.relu(z, inplace=True) if relu else z
    assert got.names == want.names and dict(bn.calls) == before
    assert got.names[-1] == ("aten.relu_.default" if relu else got.names[-1])
    composed_y = F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias, False, 0.0, m.eps)
    composed_y = F.relu(composed_y + r if r is not None else composed_y) if relu else (
        composed_y + r if r is not None else composed_y)
    assert torch.equal(y, z) and torch.equal(y, composed_y)
    assert torch.equal(x, x0) and (r is None or torch.equal(r, r0))


def test_a_tensor_on_neither_the_cpu_nor_a_card_raises():
    x = torch.empty(2, 3, device="meta")
    v = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="CUDA card"):
        bn.batch_norm(x, None, v, v, v, v, True, 0.9, 1e-5, False)


@pytest.mark.parametrize("shape,fmt,want", [
    ((3, 64, 512, 512), torch.channels_last, (786432, 64, 1)),
    ((3, 64, 512, 512), torch.contiguous_format, (3, 64, 262144)),
    ((192, 128), torch.contiguous_format, (192, 128, 1)),
    ((2, 5, 7), torch.contiguous_format, (2, 5, 7)),
])
def test_layout_reads_channels_last_and_row_major(shape, fmt, want):
    x = torch.empty(shape, device="meta")
    if fmt is torch.channels_last:
        x = x.contiguous(memory_format=fmt)
    assert bn.layout(x) == (*want, fmt)


def test_layout_refuses_other_strides():
    assert bn.layout(torch.empty(6, 4).t()) is None
    assert bn.layout(torch.empty(2, 3, 4, 5)[:, :, ::2]) is None
    assert bn.layout(torch.empty(5)) is None


# (O, C, I, vec): the EAST cell's stem, a layer3 block, layer4, the decoder's
# narrow widths, a ragged channel count, fewer rows than a tile, TRBA's stem
# as row-major planes and a plane shorter than a vector group
PLANS = [(786432, 64, 1, 4), (12288, 1024, 1, 4), (3072, 2048, 1, 4), (196608, 32, 1, 4),
         (3072, 8, 1, 4), (1000, 3, 1, 1), (5, 256, 1, 4), (192, 64, 4096, 4), (192, 512, 15, 1),
         (2, 7, 9, 1)]


@pytest.mark.parametrize("O,C,I,vec", PLANS)
@pytest.mark.parametrize("blocks", [132 * 4, 132 * 2, 8])
def test_plan_covers_each_row_vector_and_channel_once(O, C, I, vec, blocks):
    pl = bn.plan(O, C, I, vec, blocks)
    assert pl.tc & (pl.tc - 1) == 0 and 1 <= pl.tc <= 32
    if I == 1:
        reduced = O
        assert pl.chunks == -(-C // (pl.tc * vec)) and pl.tc * vec * pl.chunks >= C
        assert pl.tc == 32 or pl.tc * vec >= C  # a chunk spans all channels or 32 threads
    else:
        reduced = O * I // vec
        assert pl.tc == 1 and pl.chunks == C
    assert (pl.nb - 1) * pl.span < reduced <= pl.nb * pl.span  # no empty block
    assert pl.nb * pl.chunks <= max(blocks, pl.chunks)  # at most about one wave
    assert pl.args(torch.float32)[:6] == [O, I, C, pl.tc, pl.nb, pl.span]


def test_cost_counts_each_tensor_once():
    ops, nbytes = bn.cost(3072, 2048, 1, torch.float32, residual=True, relu=True, backward=False)
    assert nbytes == 3072 * 2048 * 4 * 3 and ops == 3072 * 2048 * 6
    ops, nbytes = bn.cost(3072, 2048, 1, torch.bfloat16, residual=True, relu=True, backward=True)
    assert nbytes == 3072 * 2048 * 2 * 5 and ops == 3072 * 2048 * 9  # g, x, y, dx, dr
    ops, nbytes = bn.cost(3, 64, 9, torch.float64, residual=False, relu=True, backward=True)
    assert nbytes == 3 * 64 * 9 * 8 * 3 and ops == 3 * 64 * 9 * 11  # g, x, dx; the mask from x
