"""The EAST trainer's optimizer step over all its leaves at once: kernels and
plain twins.

Three fused pieces of work, each over a list of parameter tensors:

* ``perturb``: SAM/ASAM's step to params + e_w, with
  e_w = (p² if adaptive else 1)·g·ρ/(‖(|p| if adaptive else 1)·g‖ + 1e-12),
  returning what ``restore`` needs;
* ``restore``: the parameters back to what they were, bit for bit;
* ``clip_sgd_apply``: the guard (every gradient zeroed when the loss is not
  finite), clip by global norm, SGD's momentum trace, the learning-rate
  scale and the apply, the trace and the parameters updated in place.

On a card they launch the kernels of ``csrc/multi_tensor.cu``: a sum of
squares that writes one partial sum per chunk, then one kernel that reads
the partials, forms the norm on the card and updates every leaf; the
restore is one kernel. No launch waits for the card. The kernels take
float32, float64 and bfloat16 leaves (``DTYPES``), all of one type on one
card, each tensor row-major or channels_last; anything else on a card
raises ``ValueError`` (``on_card``). Their arithmetic is torch's
elementwise arithmetic for that type in the plain loops' order, so given
the same norm they equal the plain loops bit for bit; the norms differ
only by summation order (the kernels sum squares in double). Each launch
group runs in the profiler region ``optim.multi_tensor``.

On the CPU the perturbation and the restore run ``perturb_plain`` and
``restore_plain``, the loops the trainer ran before the kernels; the
update there is the optimizer's own transforms (``optim.clip_sgd_step``).

The kernels see the leaves as one concatenation in which each leaf starts
at a multiple of ``ALIGN`` elements, cut into chunks of ``CHUNK``
elements; ``plan`` lays it out (in groups of at most ``MAX_LEAVES``
leaves, one launch each) and ``walk`` models how a block walks one chunk.
The kernels write tensors through their addresses, which autograd's
version counters do not see: the trainer calls them where no graph holds
the parameters.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import annotate
from . import _build

CHUNK = 32768  # elements of the concatenation a block walks at a time (MT_CHUNK)
MAX_LEAVES = 512  # leaves in one launch's table (MT_MAX_LEAVES)
ALIGN = 4  # each leaf starts at a multiple of 4 elements: one 4-element load
EPS = 1e-12  # SAM's ε under the norm
DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}  # the kernels' element types

kernel_launches = 0  # kernel launches made


class Group(NamedTuple):
    """Leaves [first, last) of a plan, one launch of each kernel."""

    first: int
    last: int
    offsets: np.ndarray  # int64 (n + 1,): each leaf's start in the concatenation, then the end
    numels: np.ndarray  # int32 (n,)
    chunks: int
    chunk_base: int  # its first chunk's slot among the plan's partial sums
    flat_base: int  # its first element in the plan's flat buffer (the saved parameters)


class Plan(NamedTuple):
    groups: Tuple[Group, ...]
    chunks: int  # all groups' chunks: the partial sums
    flat: int  # elements of the flat buffer


@functools.lru_cache(maxsize=32)
def plan(numels: Tuple[int, ...]) -> Plan:
    """The concatenation of leaves of ``numels`` elements."""
    groups, chunk_base, flat_base = [], 0, 0
    for first in range(0, len(numels), MAX_LEAVES):
        sizes = numels[first:first + MAX_LEAVES]
        offsets = np.zeros(len(sizes) + 1, np.int64)
        offsets[1:] = np.cumsum([-(-n // ALIGN) * ALIGN for n in sizes])
        total = int(offsets[-1])
        chunks = -(-total // CHUNK)
        groups.append(Group(first, first + len(sizes), offsets, np.asarray(sizes, np.int32),
                            chunks, chunk_base, flat_base))
        chunk_base += chunks
        flat_base += total
    return Plan(tuple(groups), chunk_base, flat_base)


def walk(group: Group, chunk: int, aligned: Callable[[int, int], bool] = lambda leaf, start: True
         ) -> List[Tuple[int, int, int, int]]:
    """How a block of the kernels walks chunk ``chunk`` of ``group``:
    (leaf, start, vector stop, stop) for each leaf (counted from the
    group's first) with elements in the chunk. Elements [start, vector stop)
    go 4 at a time, [vector stop, stop) one by one; a piece goes 4 at a
    time when ``aligned(leaf, start)``: all its tensors row-major and their
    addresses at ``start`` aligned to 4 elements."""
    off, numels = group.offsets, group.numels
    lo, hi = chunk * CHUNK, (chunk + 1) * CHUNK
    a, b = 0, len(numels) - 1  # the last leaf that starts at or before lo
    while a < b:
        m = (a + b + 1) >> 1
        if off[m] <= lo:
            a = m
        else:
            b = m - 1
    out = []
    for leaf in range(a, len(numels)):
        if off[leaf] >= hi:
            break
        s = max(lo, int(off[leaf])) - int(off[leaf])
        e = min(hi, int(off[leaf]) + int(numels[leaf])) - int(off[leaf])
        if s < e:
            out.append((leaf, s, s + (e - s) // 4 * 4 if aligned(leaf, s) else s, e))
    return out


def cost(work: str, elements: int) -> Tuple[int, int]:
    """(f32 operations, bytes) of one ``perturb`` (its sum of squares and the
    perturbation), ``restore`` or ``update`` (``clip_sgd_apply``) over
    ``elements`` float32 elements: each input read once and each output
    written once (the kernels read the inputs of the sum of squares twice).
    Operations a element: |p|·g, its square and the sum, then p·p, ·g,
    ·scale, + p (perturb); none (restore); g², the sum, the guard, the
    clip's ÷ and ·, the trace's · and +, the scale's · and + p (update)."""
    ops, words = {"perturb": (7, 4), "restore": (0, 2), "update": (10, 5)}[work]
    return ops * elements, 4 * words * elements


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


def on_card(*leaves: Sequence[torch.Tensor], loss: Optional[torch.Tensor] = None) -> bool:
    """Whether these tensors take the kernels: False when every one is on
    the CPU (the plain routes), True when every leaf is of one type of
    ``DTYPES`` on one card and ``loss`` (if given) one number of such a
    type there. Raises ``ValueError`` for anything else: tensors on several
    devices, on neither the CPU nor a card, of mixed or other types."""
    tensors = [t for ts in leaves for t in ts]
    every = tensors + ([] if loss is None else [loss])
    if not tensors or all(t.device.type == "cpu" for t in every):
        return False
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda" or dtype not in DTYPES:
        raise ValueError(f"multi_tensor: leaves of {dtype} on {dev}: the kernels take "
                         f"{', '.join(map(str, DTYPES))} on a CUDA card")
    odd = {(t.device, t.dtype) for t in tensors} - {(dev, dtype)}
    if odd:
        raise ValueError(f"multi_tensor: every leaf one type on one card; {dtype} on {dev} "
                         f"beside {sorted(map(str, odd))}")
    if loss is not None and (loss.device != dev or loss.dtype not in DTYPES or loss.numel() != 1):
        raise ValueError(f"multi_tensor: the loss must be one number on {dev} of "
                         f"{', '.join(map(str, DTYPES))}; got {tuple(loss.shape)} {loss.dtype} "
                         f"on {loss.device}")
    return True


def strided_offset(i: int, c: int, hw: int) -> int:
    """Where element i (row-major) of a leaf lies in an (O, C, H·W) tensor
    stored as (O, H·W, C), channels_last (the kernels' strided_at)."""
    o, r = divmod(i, c * hw)
    ci, k = divmod(r, hw)
    return o * c * hw + k * c + ci


# ---- plain twins: the loops the trainer ran, leaf by leaf ----

def perturb_plain(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], rho: float,
                  adaptive: bool, norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """params ← params + e_w in place → copies of the params before it.
    ``norm`` replaces ‖(|p| if adaptive else 1)·g‖ (to hold the kernels'
    elementwise arithmetic to this with their own norm)."""
    if norm is None:
        norm = global_norm([torch.abs(p) * g for p, g in zip(params, grads)] if adaptive else grads)
    scale = rho / (norm + EPS)
    e_w = ([torch.square(p) * g * scale for p, g in zip(params, grads)] if adaptive
           else [g * scale for g in grads])
    saved = [p.detach().clone() for p in params]
    for p, e in zip(params, e_w):
        p.copy_(p + e)
    return saved


def restore_plain(params: Sequence[torch.Tensor], saved: Sequence[torch.Tensor]) -> None:
    for p, s in zip(params, saved):
        p.copy_(s)


# ---- the kernels ----

class Saved(NamedTuple):
    """What ``perturb_cuda`` kept for ``restore_cuda``: the parameters before
    the step, end to end as ``plan`` lays them out."""

    flat: torch.Tensor
    plan: Plan


def _lib():
    lib = _build.library("multi_tensor")
    if lib.multi_tensor_sumsq.argtypes is None:
        p, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
        table = [p, p, p, p, p, i, ll, i]  # off, numel, c, hw, strided, n, chunks, dtype
        for name, args in (
            ("multi_tensor_sumsq", [p, p, *table, i, p, p]),
            ("multi_tensor_perturb", [p, p, *table, p, p, i, d, d, i, p, p]),
            ("multi_tensor_restore", [p, *table, p, p]),
            ("multi_tensor_update", [p, p, p, *table, p, i, p, i, d, d, d, p, p]),
        ):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = ctypes.c_int, args
        for name in ("multi_tensor_max_leaves", "multi_tensor_chunk"):
            getattr(lib, name).restype = ctypes.c_int
        if (lib.multi_tensor_max_leaves(), lib.multi_tensor_chunk()) != (MAX_LEAVES, CHUNK):
            raise RuntimeError("multi_tensor: csrc/multi_tensor.cu and its wrapper disagree on "
                               "MAX_LEAVES or CHUNK")
    return lib


class _Table(NamedTuple):
    """The leaves as the kernels take them: each list's addresses, and each
    leaf's layout (c, hw, and bit d of ``strided`` for list d)."""

    ptrs: Tuple[np.ndarray, ...]
    c: np.ndarray
    hw: np.ndarray
    strided: np.ndarray

    def args(self, grp: Group, dtype: torch.dtype) -> list:
        """The C arguments of one group: its lists' addresses, then offsets,
        sizes, layouts, leaf count, chunks and element type."""
        k = grp.first
        return [*(a[k:].ctypes.data for a in self.ptrs), grp.offsets.ctypes.data,
                grp.numels.ctypes.data, self.c[k:].ctypes.data, self.hw[k:].ctypes.data,
                self.strided[k:].ctypes.data, grp.last - k, grp.chunks, DTYPES[dtype]]


def _table(lists: Sequence[Sequence[torch.Tensor]], written: Sequence[bool]) -> _Table:
    """The table of ``lists`` (parameters first). A tensor is read through
    its layout: row-major, or an (O, C, H, W) tensor stored as (O, H, W, C)
    (channels_last, as autograd returns a KxK convolution's gradient for a
    channels_last input). A tensor that is only read and has another layout
    is copied to row-major; a written one raises ``ValueError``."""
    n = len(lists[0])
    c, hw, strided = np.ones(n, np.int32), np.ones(n, np.int32), np.zeros(n, np.uint8)
    out = [list(ts) for ts in lists]
    for d, (ts, w) in enumerate(zip(lists, written)):
        if len(ts) != n:
            raise ValueError(f"multi_tensor: {len(ts)} tensors beside {n} parameters")
        for i, t in enumerate(ts):
            if t.shape != lists[0][i].shape:
                raise ValueError(f"multi_tensor: a tensor of shape {tuple(t.shape)} beside a "
                                 f"parameter of shape {tuple(lists[0][i].shape)}")
            if t.is_contiguous():
                continue
            if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
                c[i], hw[i] = t.shape[1], t.shape[2] * t.shape[3]
                strided[i] |= 1 << d
            elif not w:
                out[d][i] = t.contiguous()
            else:
                raise ValueError(f"multi_tensor: a written tensor of shape {tuple(t.shape)} and "
                                 f"strides {t.stride()} is neither row-major nor channels_last")
    ptrs = tuple(np.fromiter((t.data_ptr() for t in ts), np.uint64, n) for ts in out)
    return _Table(ptrs, c, hw, strided)


def _launch(status: int, what: str) -> None:
    global kernel_launches
    _build.check(status, f"multi_tensor {what}")
    kernel_launches += 1


def _sumsq(lib, pl: Plan, table: _Table, dtype, adaptive: bool, partials: torch.Tensor,
           stream: int) -> None:
    """partials[chunk] = the chunk's sum of (|p|·g)² (adaptive) or g²; the
    table's two lists are p and g."""
    for grp in pl.groups:
        if grp.chunks:
            _launch(lib.multi_tensor_sumsq(
                *table.args(grp, dtype), int(adaptive), partials.data_ptr() + 8 * grp.chunk_base,
                stream), "sum of squares")


def perturb_cuda(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], rho: float,
                 adaptive: bool, norm_out: Optional[torch.Tensor] = None) -> Saved:
    """``perturb_plain`` in two launches on the current stream; ``norm_out``
    (one number of the leaves' type on the card) receives the norm the
    kernel used."""
    table = _table([params, grads], [True, False])
    dev, dtype = params[0].device, params[0].dtype
    pl = plan(tuple(p.numel() for p in params))
    saved = Saved(torch.empty(pl.flat, dtype=dtype, device=dev), pl)
    if not pl.chunks:
        return saved
    lib = _lib()
    partials = torch.empty(pl.chunks, dtype=torch.float64, device=dev)
    size = saved.flat.element_size()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _sumsq(lib, pl, table, dtype, adaptive, partials, stream)
        for grp in pl.groups:
            if grp.chunks:
                _launch(lib.multi_tensor_perturb(
                    *table.args(grp, dtype), saved.flat.data_ptr() + size * grp.flat_base,
                    partials.data_ptr(), pl.chunks, rho, EPS, int(adaptive),
                    None if norm_out is None else norm_out.data_ptr(), stream), "perturb")
    return saved


def restore_cuda(params: Sequence[torch.Tensor], saved: Saved) -> None:
    """``restore_plain`` in one launch on the current stream."""
    table = _table([params], [True])
    dev, dtype = params[0].device, saved.flat.dtype
    lib = _lib()
    size = saved.flat.element_size()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for grp in saved.plan.groups:
            if grp.chunks:
                _launch(lib.multi_tensor_restore(
                    *table.args(grp, dtype), saved.flat.data_ptr() + size * grp.flat_base,
                    stream), "restore")


def clip_sgd_apply_cuda(loss: torch.Tensor, grads: Sequence[torch.Tensor],
                        traces: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
                        max_norm: float, step: float, momentum: float,
                        norm_out: Optional[torch.Tensor] = None) -> None:
    """g ← 0 unless the loss is finite; g ← (g / ‖g‖)·max where ‖g‖ ≥ max;
    t ← g + momentum·t; p ← p + step·t, in place (``step`` is −lr), in two
    launches on the current stream, the loss read on the card; ``norm_out``
    receives the guarded gradients' norm."""
    table = _table([params, grads, traces], [True, False, True])
    dev, dtype = params[0].device, params[0].dtype
    pl = plan(tuple(p.numel() for p in params))
    if not pl.chunks:
        return
    lib = _lib()
    partials = torch.empty(pl.chunks, dtype=torch.float64, device=dev)
    # the sum of squares reads the gradients as both of its lists
    squares = table._replace(ptrs=(table.ptrs[1], table.ptrs[1]),
                             strided=np.where(table.strided & 2, 3, 0).astype(np.uint8))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _sumsq(lib, pl, squares, dtype, False, partials, stream)
        for grp in pl.groups:
            if grp.chunks:
                _launch(lib.multi_tensor_update(
                    *table.args(grp, dtype), partials.data_ptr(), pl.chunks, loss.data_ptr(),
                    DTYPES[loss.dtype], max_norm, momentum, step,
                    None if norm_out is None else norm_out.data_ptr(), stream), "update")


# ---- the routes ----

def perturb(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], rho: float,
            adaptive: bool):
    """params ← params + e_w in place → what ``restore`` takes."""
    if not on_card(params, grads):
        return perturb_plain(params, grads, rho, adaptive)
    with annotate("optim.multi_tensor"):
        return perturb_cuda(params, grads, rho, adaptive)


def restore(params: Sequence[torch.Tensor], saved) -> None:
    """params ← what ``perturb`` returned, bit for bit."""
    if not isinstance(saved, Saved):
        return restore_plain(params, saved)
    with annotate("optim.multi_tensor"):
        restore_cuda(params, saved)


@torch.no_grad()
def clip_sgd_apply(loss: torch.Tensor, grads: Sequence[torch.Tensor],
                   traces: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
                   max_norm: float, step: float, momentum: float) -> None:
    """``clip_sgd_apply_cuda`` in its region; the leaves must be on a card
    (``on_card``)."""
    if not on_card(params, grads, traces, loss=loss):
        raise ValueError("multi_tensor.clip_sgd_apply: leaves on the CPU run the optimizer's "
                         "transforms (optim.clip_sgd_step)")
    with annotate("optim.multi_tensor"):
        clip_sgd_apply_cuda(loss, grads, traces, params, max_norm, step, momentum)
