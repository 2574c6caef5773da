"""Train-mode BatchNorm with an optional residual and ReLU (K7): the kernels
of ``csrc/batch_norm.cu`` and their plain twin.

``batch_norm(x, residual, weight, bias, running_mean, running_var, update,
momentum, eps, relu)`` computes y = act(BN(x) + r) over channel dim 1:
BN(x) = (x − mean)·(invstd·weight) + bias with the batch mean and the
biased batch variance over every other axis, invstd = rsqrt(var + eps),
``residual`` r optional, act ReLU when ``relu`` else the identity; with
``update`` the running statistics move as flax moves them,
running = momentum·running + (1 − momentum)·batch. It differentiates with
respect to x, r, weight and bias, once (``once_differentiable``). float32
and bfloat16 inputs compute in float32, float64 inputs in float64; the
per-channel vectors are of that type.

On a card it launches the kernels: a statistics kernel and an apply kernel
forward, a kernel of the gradient's per-channel sums and an apply kernel
backward (``launches`` counts them, 4 a call). They take float32, float64
and bfloat16 (``DTYPES``), ``x`` channels_last 4-D (an (N·H·W, C) matrix)
or row-major (N, C, S…), 2-D (N, C) included (``layout``), the residual of
the same shape, type and layout, and the per-channel vectors contiguous in
the computing type; anything else on a card raises ``ValueError``. How a
launch cuts the tensor is ``plan``'s: it adapts to the shape, M rows
against C channels, and to the card's SMs, so a result repeats bit for bit.
A gradient that arrives in another layout is copied to x's first.

On the CPU the same arithmetic runs as torch ops, the twin
(``forward_plain``, ``backward_plain``): the forward and a backward in
closed form, which the CPU tests hold to the composed autograd path and to
``gradcheck``. ``calls`` counts the train-mode calls by route, ``"kernel"``
against ``"twin"``. Each forward runs in the profiler region ``bn.forward``
and each backward in ``bn.backward`` (on autograd's worker thread on a
card).

The kernels' statistics merge per-block partials in a fixed order; the last
block of each channel chunk, found with a ticket counter that the card
keeps, finishes them. The counters wrap back to 0 at the end of each
launch and are reused by the next; each stream has its own array, so
launches on two streams of one card may run at once.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from contextlib import nullcontext
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..utils.profiling import annotate
from . import _build

THREADS = 256  # a block's threads (BN_THREADS)
UNROLL = 4  # loads in flight a thread (BN_UNROLL)
TICKETS = 65535  # channel chunks (rows) or channels (planes) a launch may have: the grid's y
DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}  # the kernels' element types

launches = 0  # kernel launches made
calls: Counter = Counter()  # train-mode calls by route: "kernel" (a card), "twin" (the CPU)


class Plan(NamedTuple):
    """How the kernels cut an (O, C, I) tensor: ``nb`` blocks along the
    reduced axis by ``chunks`` along the channels."""

    O: int  # rows (I == 1) or planes
    C: int
    I: int  # elements of a plane along the contiguous axis; 1: an (O, C) matrix
    vec: int  # elements a load: 4 or 1
    tc: int  # rows: threads of a block along the channels (planes: 1)
    nb: int  # blocks along the reduced axis
    span: int  # rows (rows) or vectors of a channel (planes) a block
    chunks: int  # rows: chunks of tc·vec channels; planes: C

    def args(self, dtype: torch.dtype) -> list:
        return [self.O, self.I, self.C, self.tc, self.nb, self.span, DTYPES[dtype], self.vec]


def plan(O: int, C: int, I: int, vec: int, blocks: int) -> Plan:
    """The cut for ``blocks`` blocks resident on the card at once (its SMs
    times the kernels' occupancy): rows give each thread ``vec`` channels
    and a block 256/tc rows at a time, planes give a block one channel;
    either way at most ``blocks`` blocks in all (or one a chunk), each
    thread with at least one full group of ``UNROLL`` loads."""
    if I == 1:
        tc = min(32, 1 << (-(-C // vec) - 1).bit_length())
        chunks = -(-C // (tc * vec))
        nb = max(1, min(blocks // chunks, -(-O // (THREADS // tc * UNROLL))))
        span = -(-O // nb)
        return Plan(O, C, I, vec, tc, -(-O // span), span, chunks)
    vectors = O * I // vec
    nb = max(1, min(blocks // C, -(-vectors // (THREADS * UNROLL))))
    span = -(-vectors // nb)
    return Plan(O, C, I, vec, 1, -(-vectors // span), span, C)


def layout(x: torch.Tensor) -> Optional[Tuple[int, int, int, torch.memory_format]]:
    """(O, C, I, memory format) of ``x`` as the kernels read it: row-major
    (N, C, S…) as (N, C, prod S), channels_last (N, C, H, W) as an
    (N·H·W, C, 1) matrix; None for any other layout."""
    if x.dim() < 2:
        return None
    inner = math.prod(x.shape[2:])
    if x.is_contiguous():
        return x.shape[0], x.shape[1], inner, torch.contiguous_format
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return x.shape[0] * inner, x.shape[1], 1, torch.channels_last
    return None


def cost(O: int, C: int, I: int, dtype: torch.dtype, residual: bool, relu: bool,
         backward: bool) -> Tuple[int, int]:
    """(operations, bytes) of one forward or backward: each tensor it needs
    read once and each output written once (the kernels read x, and in the
    backward g, twice). Forward: x (and r) read, y written; a subtract, a
    multiply, an add (and an add, a max) an element. Backward: g and x read
    (and y, for the ReLU's mask beside a residual), dx (and dr) written;
    the mask (from x: BN(x) again, a multiply-add and a compare), x̂'s
    subtract and multiply, the two sums, and dx's subtract, multiply-subtract
    and multiply an element."""
    n, size = O * C * I, torch.finfo(dtype).bits // 8
    if not backward:
        return n * (3 + 2 * relu + residual), n * size * (2 + residual)
    mask_ops = (1 if residual else 3) if relu else 0
    return n * (8 + mask_ops), n * size * (3 + (relu and residual) + residual)


# ---- the plain twin: the kernels' arithmetic in torch ops ----

def _dims(x: torch.Tensor):
    return [0] + list(range(2, x.dim())), (1, -1) + (1,) * (x.dim() - 2)


def _acc(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float64 else t.float()


def forward_plain(x, residual, weight, bias, running_mean, running_var, update: bool,
                  momentum: float, eps: float, relu: bool):
    """The forward in torch ops → (y, stats): stats[0] the batch mean,
    stats[1] invstd, in the computing type."""
    dims, shape = _dims(x)
    xf = _acc(x)
    mean = xf.mean(dims)
    xc = xf - mean.view(shape)
    var = xc.square().mean(dims)
    if update:
        running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
        running_var.copy_(momentum * running_var + (1 - momentum) * var)
    invstd = torch.rsqrt(var + eps)
    out = xc * (invstd * weight).view(shape) + bias.view(shape)
    if residual is not None:
        out = out + _acc(residual)
    if relu:
        out = torch.relu(out)
    return out.to(x.dtype), torch.stack([mean, invstd])


def backward_plain(g, x, y, stats, weight, relu: bool, residual: bool):
    """The backward in closed form → (dx, dr, dweight, dbias); ``y`` (the
    forward's output) is read under ReLU only, dr is None without a
    residual."""
    dims, shape = _dims(x)
    mean, invstd = stats
    gp = _acc(g)
    if relu:
        gp = gp.masked_fill(y <= 0, 0)
    xhat = (_acc(x) - mean.view(shape)) * invstd.view(shape)
    sg, sgx = gp.sum(dims), (gp * xhat).sum(dims)
    m = x.numel() // x.shape[1]
    dx = (weight * invstd).view(shape) * (gp - (sg / m).view(shape) - xhat * (sgx / m).view(shape))
    return (dx.to(x.dtype), gp.to(x.dtype) if residual else None, sgx.to(weight.dtype),
            sg.to(weight.dtype))


# ---- the kernels ----

def _lib():
    lib = _build.library("batch_norm")
    if lib.batch_norm_stats.argtypes is None:
        p, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
        shape = [ll, ll, i, i, ll, ll, i, i]  # O, I, C, tc, nb, span, dtype, vec
        for name, args in (
            ("batch_norm_stats", [p, *shape, p, p, p, p, p, p, p, d, d, p]),
            ("batch_norm_apply", [p, p, p, *shape, p, p, p, p, i, p]),
            ("batch_norm_grad_sums", [p, p, p, *shape, p, p, p, p, p, p, p, p, p, i, p]),
            ("batch_norm_grad_apply", [p, p, p, p, p, *shape, p, p, p, p, p, p, i, p]),
            ("batch_norm_occupancy", [i, i, i, i]),
        ):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = ctypes.c_int, args
        for name in ("batch_norm_threads", "batch_norm_unroll"):
            getattr(lib, name).restype = ctypes.c_int
        if (lib.batch_norm_threads(), lib.batch_norm_unroll()) != (THREADS, UNROLL):
            raise RuntimeError("batch_norm: csrc/batch_norm.cu and its wrapper disagree on "
                               "THREADS or UNROLL")
    return lib


STATS, APPLY, SUMS, GRAD = range(4)  # the kernels, as batch_norm_occupancy numbers them
# blocks an SM of the reductions (STATS, SUMS): each block leaves one
# partial a channel for the last block to merge, and two blocks of 256
# threads keep enough loads in flight to stream at the card's rate
REDUCE_PER_SM = 2

# per device and shape, found once: the host's work a call is most of a
# small layer's time
_blocks: Dict[tuple, int] = {}  # (device, planes, dtype, vec, kernel) → blocks of one wave
_layouts: Dict[tuple, Optional[tuple]] = {}  # (shape, strides) → layout
_cuts: Dict[tuple, tuple] = {}  # → (first kernel's arguments, second's, first's blocks)
_tickets: Dict[tuple, Tuple[torch.Tensor, int]] = {}  # (device, stream) → (counters, address)


def _plan(dev: torch.device, O: int, C: int, I: int, vec: int, dtype: torch.dtype,
          kernel: int) -> Plan:
    """``plan`` for one wave of ``kernel``'s blocks on the card."""
    key = (dev.index, I > 1, dtype, vec, kernel)
    if key not in _blocks:
        per_sm = _lib().batch_norm_occupancy(int(I > 1), DTYPES[dtype], vec, kernel)
        if per_sm < 1:
            raise RuntimeError(f"batch_norm: no block of the kernels fits on {dev} ({per_sm})")
        if kernel in (STATS, SUMS):
            per_sm = min(per_sm, REDUCE_PER_SM)
        _blocks[key] = per_sm * torch.cuda.get_device_properties(dev).multi_processor_count
    pl = plan(O, C, I, vec, _blocks[key])
    if pl.chunks > TICKETS:
        raise ValueError(f"batch_norm: {C} channels, more than the kernels' grid takes")
    return pl


def _layout(x: torch.Tensor) -> Optional[tuple]:
    """``layout(x)``, found once a shape and strides."""
    key = (x.shape, x.stride())
    lay = _layouts.get(key, False)
    if lay is False:
        lay = _layouts[key] = layout(x)
    return lay


def _cut(x: torch.Tensor, vec: int, first: int) -> tuple:
    """The C arguments of the plans of kernel ``first`` (STATS or SUMS) and
    of the one after it (APPLY or GRAD) for x, and the first's blocks along
    the reduced axis (its partials a channel)."""
    key = (x.device.index, x.shape, x.stride(), x.dtype, vec, first)
    cut = _cuts.get(key)
    if cut is None:
        O, C, I, _ = _layout(x)
        a, b = (_plan(x.device, O, C, I, vec, x.dtype, k) for k in (first, first + 1))
        cut = _cuts[key] = (a.args(x.dtype), b.args(x.dtype), a.nb)
    return cut


def _tickets_of(dev: torch.device, stream: int) -> int:
    """The address of the ticket counters of ``stream`` on ``dev``, zero
    between launches: launches on one stream run one after another, so they
    never hold a counter at once."""
    t = _tickets.get((dev.index, stream))
    if t is None:
        counters = torch.zeros(TICKETS, dtype=torch.int32, device=dev)
        t = _tickets[dev.index, stream] = (counters, counters.data_ptr())
    return t[1]


def _on(dev: torch.device):
    """The device's context, entered only when another device is current."""
    return nullcontext() if torch.cuda.current_device() == dev.index else torch.cuda.device(dev)


def _vec(C: int, I: int, *tensors: Optional[torch.Tensor]) -> int:
    """4 when every row (I == 1) or plane holds a multiple of 4 elements and
    every address is aligned to 4 of them, else 1."""
    size = 4 * tensors[0].element_size()
    whole = C % 4 == 0 if I == 1 else I % 4 == 0
    return 4 if whole and all(t.data_ptr() % size == 0 for t in tensors if t is not None) else 1


def _launch(status: int, what: str) -> None:
    global launches
    _build.check(status, f"batch_norm {what}")
    launches += 1


def _checked(x, residual, weight, bias, running_mean, running_var):
    """x's (O, C, I, format), or ``ValueError`` for what the kernels do not take."""
    if x.dtype not in DTYPES:
        raise ValueError(f"batch_norm: x of {x.dtype}; the kernels take "
                         f"{', '.join(map(str, DTYPES))}")
    lay = _layout(x)
    if lay is None:
        raise ValueError(f"batch_norm: x of shape {tuple(x.shape)} and strides {x.stride()} is "
                         "neither row-major (N, C, ...) nor channels_last 4-D")
    O, C, I, fmt = lay
    if O * I == 0:
        raise ValueError(f"batch_norm: x of shape {tuple(x.shape)} has no element a channel")
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    for name, v in (("weight", weight), ("bias", bias), ("running_mean", running_mean),
                    ("running_var", running_var)):
        if v.device != x.device or v.dtype != acc or v.shape != (C,) or not v.is_contiguous():
            raise ValueError(f"batch_norm: {name} must be a contiguous ({C},) {acc} tensor on "
                             f"{x.device}; got {tuple(v.shape)} {v.dtype} on {v.device}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype
                                 or residual.device != x.device
                                 or not residual.is_contiguous(memory_format=fmt)):
        raise ValueError(f"batch_norm: the residual must have x's shape, type, device and "
                         f"layout ({tuple(x.shape)}, {x.dtype}, {x.device}, {fmt}); got "
                         f"{tuple(residual.shape)}, {residual.dtype}, {residual.device}, "
                         f"strides {residual.stride()}")
    return lay


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def forward_cuda(x, residual, weight, bias, running_mean, running_var, update: bool,
                 momentum: float, eps: float, relu: bool):
    """``forward_plain`` in two launches on the current stream → (y, stats)."""
    O, C, I, fmt = _checked(x, residual, weight, bias, running_mean, running_var)
    dev = x.device
    first, second, nb = _cut(x, _vec(C, I, x, residual), STATS)
    y = torch.empty_like(x, memory_format=fmt)
    stats = torch.empty((2, C), dtype=weight.dtype, device=dev)  # mean, invstd
    partials = torch.empty(2 * nb * C, dtype=weight.dtype, device=dev)
    at, part, row = stats.data_ptr(), partials.data_ptr(), C * stats.element_size()
    lib = _lib()
    with _on(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(lib.batch_norm_stats(
            x.data_ptr(), *first, part, part + nb * row, _tickets_of(dev, stream), at, at + row,
            running_mean.data_ptr() if update else None,
            running_var.data_ptr() if update else None, momentum, eps, stream), "statistics")
        _launch(lib.batch_norm_apply(
            x.data_ptr(), _ptr(residual), y.data_ptr(), *second, at, at + row, weight.data_ptr(),
            bias.data_ptr(), int(relu), stream), "apply")
    return y, stats


def backward_cuda(g, x, y, stats, weight, bias, relu: bool, residual: bool,
                  need_x: bool = True, need_r: bool = True):
    """``backward_plain`` in two launches on the current stream (one when
    neither dx nor dr is wanted) → (dx or None, dr or None, dweight, dbias).
    ``residual`` says whether the forward added one, ``need_x`` and
    ``need_r`` whether dx and dr are wanted (dr only beside a residual).
    Under the ReLU the mask is y <= 0 beside a residual, else BN(x) <= 0
    recomputed from x as the forward rounded it (``y`` unread, may be
    None). ``g`` is copied to x's layout first if it has another."""
    O, C, I, fmt = _layout(x)
    if not g.is_contiguous(memory_format=fmt):
        g = g.contiguous(memory_format=fmt)
    mask = 0 if not relu else 1 if residual else 2
    y = y if mask == 1 else None
    dev = x.device
    dx = torch.empty_like(x, memory_format=fmt) if need_x else None
    dr = torch.empty_like(x, memory_format=fmt) if residual and need_r else None
    first, second, nb = _cut(x, _vec(C, I, g, x, y, dx, dr), SUMS)
    dweight, dbias = torch.empty_like(weight), torch.empty_like(weight)
    partials = torch.empty(2 * nb * C, dtype=weight.dtype, device=dev)
    at, part, row = stats.data_ptr(), partials.data_ptr(), C * stats.element_size()
    vectors = (at, at + row, weight.data_ptr(), bias.data_ptr())
    lib = _lib()
    with _on(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(lib.batch_norm_grad_sums(
            g.data_ptr(), x.data_ptr(), _ptr(y), *first, *vectors, part, part + nb * row,
            _tickets_of(dev, stream), dweight.data_ptr(), dbias.data_ptr(), mask, stream),
            "gradient sums")
        if dx is not None or dr is not None:
            _launch(lib.batch_norm_grad_apply(
                g.data_ptr(), x.data_ptr(), _ptr(y), _ptr(dx), _ptr(dr), *second, *vectors,
                dweight.data_ptr(), dbias.data_ptr(), mask, stream), "gradient apply")
    return dx, dr, dweight, dbias


class _BatchNorm(torch.autograd.Function):
    """The kernels for x on a card, the twin on the CPU."""

    @staticmethod
    def forward(ctx, x, residual, weight, bias, running_mean, running_var, update, momentum, eps,
                relu):
        card = x.device.type == "cuda"
        with annotate("bn.forward"):
            y, stats = (forward_cuda if card else forward_plain)(
                x, residual, weight, bias, running_mean, running_var, update, momentum, eps, relu)
        # the kernels' ReLU mask reads y beside a residual, else BN(x) from x
        keep_y = relu and (residual is not None or not card)
        ctx.save_for_backward(x, y if keep_y else None, stats, weight, bias)
        ctx.card, ctx.relu, ctx.residual = card, relu, residual is not None
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with annotate("bn.backward"):
            x, y, stats, weight, bias = ctx.saved_tensors
            if ctx.card:
                grads = backward_cuda(g, x, y, stats, weight, bias, ctx.relu, ctx.residual,
                                      ctx.needs_input_grad[0], ctx.needs_input_grad[1])
            else:
                grads = backward_plain(g, x, y, stats, weight, ctx.relu, ctx.residual)
        return (*grads, None, None, None, None, None, None)


# ---- the route ----

def batch_norm(x: torch.Tensor, residual: Optional[torch.Tensor], weight: torch.Tensor,
               bias: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
               update: bool, momentum: float, eps: float, relu: bool) -> torch.Tensor:
    """y = act(BN(x) + r) in train mode, differentiable: the kernels for a
    tensor on a card, the twin for one on the CPU."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"batch_norm: x on {x.device}; the kernels run on a CUDA card")
    calls["kernel" if x.device.type == "cuda" else "twin"] += 1
    return _BatchNorm.apply(x, residual, weight, bias, running_mean, running_var, bool(update),
                            momentum, eps, bool(relu))
