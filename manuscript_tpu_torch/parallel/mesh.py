"""Device mesh and data parallelism (counterpart of
``manuscript_tpu/parallel/mesh.py``), on ``torch.distributed``.

The JAX package's mesh is pure GSPMD: ``jit`` with ``P("data")`` on the
leading axis and ``P()`` on the weights, so a sharded run computes exactly
the one-device function on the global batch, up to the order of its
reductions. The port keeps that property:

* inference: one process drives every device of the mesh. Each data row of
  the mesh gets a contiguous slice of the page axis (``shard_batch``) and
  its own copy of the models (``replicate``); nothing is reduced. A mesh
  over several processes (``torch.distributed``, one device a process, e.g.
  under ``torchrun``) gives every process the same pages: each computes its
  rank's slice and the outputs are gathered (``all_gather_rows``), so every
  process holds every page's result;
* training: one process per data row, always under a process group. The
  step's global reductions are all-reduces over the group: BatchNorm's
  statistics and the losses' numerators and denominators through the
  differentiable ``sum_over_ranks``, the gradients through
  ``average_gradients``.

The axis names are the JAX module's. The model axis holds replicas only:
nothing in the JAX package shards over it (every spec there is ``P("data")``
or ``P()``), so the devices of a data row beyond its first compute nothing in
one process, and a process on such a column computes its row's slice again.
``data_sharding``/``replicated`` are not ported: the port places tensors
with ``shard_batch``/``replicate`` and has no sharding objects.

Backends: NCCL among distinct cards, gloo on the CPU and for several ranks
on one card (NCCL refuses two ranks on one device); a gloo collective on
card tensors goes through host copies. Unlike the JAX module, ``make_mesh``
never falls back to CPU devices when there are too few cards: it raises.
"""

from __future__ import annotations

import contextlib
import copy
import os
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"

Device = Union[str, torch.device]


class Mesh:
    """A (data × model) grid of ``torch.device``s. ``devices`` is a numpy
    object array of that shape; ``group`` the process group of a mesh over
    several processes (None in one process), ``rank``/``world_size`` this
    process's place in it. Hashable by identity, so that per-mesh caches
    (``EAST``'s replicated weights) can key on it."""

    def __init__(self, devices: np.ndarray, group=None, rank: int = 0, world_size: int = 1):
        self.devices = devices
        self.group = group
        self.rank = rank
        self.world_size = world_size

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.devices.shape[0], MODEL_AXIS: self.devices.shape[1]}

    @property
    def local_shards(self) -> List[Tuple[int, torch.device]]:
        """(data row, device) of each slice this process computes: every row
        on its first device in one process; the rank's row on the rank's
        device under a process group."""
        if self.group is None:
            return [(row, self.devices[row, 0]) for row in range(self.devices.shape[0])]
        return [(self.rank // self.devices.shape[1], self.devices.flat[self.rank])]


def _backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL when every device is a distinct card, else gloo."""
    if all(d.type == "cuda" for d in devices) and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


def launcher_environment() -> bool:
    """Whether a launcher (``torchrun``) set this process's group up:
    ``WORLD_SIZE`` or ``MASTER_ADDR`` in the environment."""
    return "WORLD_SIZE" in os.environ or "MASTER_ADDR" in os.environ


def initialize_distributed(**kwargs) -> None:
    """Join a process group (``torch.distributed.init_process_group``):

    * already initialised → no-op;
    * no kwargs and no launcher environment (``WORLD_SIZE`` and
      ``MASTER_ADDR`` unset) → one process, nothing to do;
    * otherwise initialise (from the kwargs, else from the launcher's
      environment, ``env://``), with the NCCL backend when a card is
      present and gloo otherwise unless ``backend`` says; a failure is
      re-raised: a misconfigured multi-process job must fail loudly, not
      carry on in one process.
    """
    if dist.is_initialized():
        return
    if not kwargs and not launcher_environment():
        return
    kwargs.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(**kwargs)


def _own_device() -> torch.device:
    """This rank's device in a group joined without a device list: the card
    ``LOCAL_RANK`` under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        local = os.environ.get("LOCAL_RANK")
        return torch.device("cuda", int(local) if local is not None
                            else dist.get_rank() % torch.cuda.device_count())
    return torch.device("cpu")


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    devices: Optional[Sequence[Device]] = None,
) -> Mesh:
    """(data × model) mesh. With no ``devices``, in one process: the first
    ``n_devices`` cards (all cards when None); under an initialised process
    group: one device per rank, in rank order (``cuda:LOCAL_RANK`` under
    NCCL, the CPU under gloo). Raises ValueError when fewer devices exist
    than asked for (never falling back to the CPU) or when their count does
    not divide by ``model_parallel``.

    An explicit ``devices`` list (one per rank under a group) may name one
    device more than once, e.g. ``["cpu"] * 2`` or ``["cuda:0"] * 2``: the
    port's counterpart of the JAX package's virtual host devices
    (``--xla_force_host_platform_device_count``), with which the sharded
    code runs, and is tested, on one CPU or one card."""
    group, rank, world = None, 0, 1
    if dist.is_available() and dist.is_initialized():
        group, rank, world = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
        if devices is None:
            names: List[Any] = [None] * world
            dist.all_gather_object(names, str(_own_device()))
            devices = names
        if len(devices) != world:
            raise ValueError(f"a mesh over {world} processes takes one device per process, "
                             f"got {len(devices)}")
        if n_devices is not None and n_devices != world:
            raise ValueError(f"requested {n_devices} devices but the process group has {world}")
        devs = [torch.device(d) for d in devices]
    elif devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = count if n_devices is None else n_devices
        if want > count or want < 1:
            raise ValueError(f"requested {n_devices if n_devices is not None else 'all'} devices "
                             f"but only {count} available")
        devs = [torch.device("cuda", i) for i in range(want)]
    else:
        devs = [torch.device(d) for d in devices]
        if n_devices is not None:
            if len(devs) < n_devices:
                raise ValueError(f"requested {n_devices} devices but only {len(devs)} available")
            devs = devs[:n_devices]
    n = len(devs)
    if n == 0 or n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(n // model_parallel, model_parallel), group, rank, world)


def one_device_mesh(device: Device) -> Mesh:
    """The 1 × 1 mesh of ``device`` in this process, outside any process
    group: what the inference entry points run on when no mesh is given."""
    grid = np.empty((1, 1), dtype=object)
    grid[0, 0] = torch.device(device)
    return Mesh(grid)


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh: Mesh) -> list:
    """This process's slices of (a tree of) arrays or tensors: one tree per
    local shard (``mesh.local_shards``), holding rows [r·k, (r+1)·k) of each
    leaf's leading axis on the shard's device, for data row r and k = rows /
    data-axis size (a None leaf stays None). The leading axis must divide by
    the data-axis size. A pinned host tensor's slices upload asynchronously."""
    n = mesh.shape[DATA_AXIS]

    def piece(x, row: int, dev: torch.device):
        if x is None:
            return None
        t = torch.as_tensor(x)
        if t.shape[0] % n:
            raise ValueError(f"leading axis {t.shape[0]} does not divide by the data axis ({n})")
        k = t.shape[0] // n
        return t[row * k:(row + 1) * k].to(dev, non_blocking=True)

    return [_tree_map(lambda x: piece(x, row, dev), batch) for row, dev in mesh.local_shards]


def rank_rows(n: int, mesh: Mesh) -> slice:
    """The rows of an ``n``-row batch (``n`` divisible by the data-axis
    size) that this process's first local shard takes (``shard_batch``'s
    slice): under a process group, the rank's."""
    k = n // mesh.shape[DATA_AXIS]
    row = mesh.local_shards[0][0]
    return slice(row * k, (row + 1) * k)


def rank_items(items: Sequence, mesh: Mesh, repeat_last: bool = False) -> list:
    """This process's items of a global batch: ``items`` padded to a
    multiple of the data-axis size (repeating them from the first, or the
    last item with ``repeat_last``), then its ``rank_rows`` slice. A rank
    that loads only these builds its own rows of the padded batch."""
    items = list(items)
    pad = (-len(items)) % mesh.shape[DATA_AXIS]
    items += [items[-1]] * pad if repeat_last else [items[i % len(items)] for i in range(pad)]
    return items[rank_rows(len(items), mesh)]


def replicate(tree, mesh: Mesh) -> list:
    """One copy of (a tree of) tensors, or of a module, per local shard, on
    the shard's device. The copies are fresh and never alias the caller's
    tensors, also on the caller's own device: callers keep the input (the
    Lookahead slow weights and the EMA start from the parameters), and an
    update of a copy must not move it."""
    def fresh(x, dev: torch.device):
        if isinstance(x, nn.Module):
            return copy.deepcopy(x).to(dev)
        if isinstance(x, torch.Tensor):
            return x.detach().to(dev, copy=True)
        return x

    return [_tree_map(lambda x: fresh(x, dev), tree) for _, dev in mesh.local_shards]


def canonicalize_layout(tree):
    """The tree with every tensor contiguous. The JAX function runs a jitted
    identity so that weights leave the host layout (measured there: a
    relayout on every call); torch has no device layouts beyond strides, so
    this is contiguity only."""
    return _tree_map(lambda x: x.contiguous() if isinstance(x, torch.Tensor) else x, tree)


def pad_to_multiple(
    arr: np.ndarray, multiple: int, axis: int = 0, fill=0
) -> Tuple[np.ndarray, int]:
    """Pad ``axis`` up to a multiple (for even sharding); returns (padded,
    original_length)."""
    n = arr.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return arr, n
    pad_widths = [(0, 0)] * arr.ndim
    pad_widths[axis] = (0, target - n)
    return np.pad(arr, pad_widths, constant_values=fill), n


def tile_rows(arrays: Dict[str, np.ndarray], multiple: int) -> Dict[str, np.ndarray]:
    """Every array's leading axis padded to the next multiple by repeating
    its rows from the first (indices wrap when the pad exceeds the rows), as
    the JAX EAST trainer pads its batches for the mesh."""
    n = next(iter(arrays.values())).shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return dict(arrays)
    idx = np.arange(pad) % n
    return {k: np.concatenate([v, v[idx]], axis=0) for k, v in arrays.items()}


def on_device(dev: torch.device):
    """Inside: ``dev`` is the current card, so that launches on its tensors
    use its current stream; nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


# ---- collectives over a mesh's process group ------------------------------------


def _through_host(t: torch.Tensor, group) -> bool:
    """gloo reduces and gathers host tensors: card tensors go through copies."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    if _through_host(t, group):
        host = t.detach().cpu()
        dist.all_reduce(host, group=group)
        return host.to(t.device)
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


class _SumOverRanks(torch.autograd.Function):
    """y = Σ over the group's ranks of x, on every rank. Each rank then
    computes the same global function from y, so the sum of the ranks'
    objectives is world_size × the global objective, and the adjoint of y
    on each rank is the sum of the ranks' adjoints of their copies of y."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_sum(grad, ctx.group), None


def sum_over_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ of ``x`` over the ranks of ``group``, differentiable (see
    ``average_gradients``); ``x`` itself when ``group`` is None."""
    return x if group is None else _SumOverRanks.apply(x, group)


def average_gradients(grads: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Each gradient's mean over the ranks of ``group`` (one all-reduce of
    the concatenated gradients). Under ``sum_over_ranks`` the ranks' summed
    gradients are world_size × the global gradient, so the mean is the
    global one."""
    if group is None or not grads:
        return grads
    flat = _all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), group)
    flat /= dist.get_world_size(group)
    return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The data rows' slices of ``t`` (this process's slice, on its device),
    gathered in row order along the leading axis: every process gets the
    whole. In one process ``t`` is the whole already."""
    if mesh.group is None:
        return t
    src = t.detach().cpu() if _through_host(t, mesh.group) else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.world_size)]
    dist.all_gather(parts, src, group=mesh.group)
    m = mesh.shape[MODEL_AXIS]  # model-axis columns repeat their row: keep column 0
    return torch.cat(parts[::m]).to(t.device)


def broadcast_(tensors: Sequence[torch.Tensor], mesh: Mesh, src: int = 0) -> None:
    """Overwrite each tensor in place with rank ``src``'s value."""
    if mesh.group is None:
        return
    for t in tensors:
        if _through_host(t, mesh.group):
            host = t.detach().cpu()
            dist.broadcast(host, src, group=mesh.group)
            with torch.no_grad():
                t.copy_(host)
        else:
            with torch.no_grad():
                dist.broadcast(t.data, src, group=mesh.group)


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)


# ---- one call, several processes -------------------------------------------------------


def _rank_main(rank: int, fn: Callable, devices: List[str], store: str, result: str,
               args: tuple) -> None:
    devs = [torch.device(d) for d in devices]
    if devs[rank].type == "cuda":
        torch.cuda.set_device(devs[rank])
    else:  # CPU ranks share the host's cores: threads of one rank that spin
        # while it waits in a collective starve the others
        torch.set_num_threads(1)
    dist.init_process_group(_backend_for(devs), init_method=f"file://{store}",
                            world_size=len(devs), rank=rank)
    try:
        out = fn(make_mesh(devices=devices), *args)
        if rank == 0:
            torch.save(out, result)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, mesh: Mesh, *args) -> Any:
    """Run ``fn(rank_mesh, *args)`` in one new process per device of
    ``mesh`` (``torch.multiprocessing.spawn``), each under a process group
    over them all (NCCL among distinct cards, else gloo; rendezvous through
    a file in a temporary folder) with ``rank_mesh`` its mesh, and return
    rank 0's result. ``fn`` and ``args`` must pickle: ``fn`` a module-level
    function. The result is written by rank 0 with ``torch.save`` and read
    back here, its tensors on the CPU."""
    devices = [str(d) for d in mesh.devices.flat]
    with tempfile.TemporaryDirectory() as tmp:
        store, result = str(Path(tmp) / "store"), str(Path(tmp) / "result.pt")
        torch.multiprocessing.spawn(_rank_main, args=(fn, devices, store, result, args),
                                    nprocs=len(devices), join=True)
        return torch.load(result, map_location="cpu", weights_only=False)
