"""``manuscript_tpu_torch.parallel``, the port's mesh, on the CPU: the API
as ``tests/test_parallel.py`` pins the JAX module's (mesh shapes, the model
axis, an indivisible count, ``shard_batch``'s slices, ``replicate``'s fresh
copies, ``pad_to_multiple``, ``initialize_distributed``'s no-op and its
re-raise of a failed explicit initialisation, in a subprocess), and what
the port adds: a request for more cards than there are raises, never
falling back to the CPU; the collectives over a two-rank gloo group
(``sum_over_ranks`` and its gradient, ``average_gradients``,
``all_gather_rows``, ``broadcast_``), and a BatchNorm synchronised over two
ranks against the same BatchNorm on the whole batch; the one-device mesh
that the inference entry points run on without a mesh; a rank's own items
of a global batch (``rank_items``); and ``global_draws``, under which a
rank's random draws are the one-device draws of its rows.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from manuscript_tpu_torch.models.layers import (
    BatchNorm,
    dropout,
    global_draws,
    rand_rows,
    sync_batch_stats,
)
from manuscript_tpu_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    all_gather_rows,
    average_gradients,
    broadcast_,
    canonicalize_layout,
    initialize_distributed,
    make_mesh,
    one_device_mesh,
    pad_to_multiple,
    rank_items,
    rank_rows,
    replicate,
    shard_batch,
    spawn,
    sum_over_ranks,
    tile_rows,
)

ROOT = Path(__file__).resolve().parent.parent


def test_mesh_shapes_and_the_model_axis():
    mesh = make_mesh(devices=["cpu"] * 8)
    assert mesh.shape == {DATA_AXIS: 8, MODEL_AXIS: 1}
    assert make_mesh(n_devices=4, devices=["cpu"] * 8).shape[DATA_AXIS] == 4
    mesh = make_mesh(n_devices=8, model_parallel=2, devices=["cpu"] * 8)
    assert mesh.shape == {DATA_AXIS: 4, MODEL_AXIS: 2}
    assert mesh.devices.shape == (4, 2) and mesh.group is None and mesh.world_size == 1
    # one process computes every data row, on the row's first device
    assert [row for row, _ in mesh.local_shards] == [0, 1, 2, 3]
    assert len({mesh, make_mesh(devices=["cpu"] * 8)}) == 2  # hashable, by identity


def test_indivisible_or_too_many_devices_raise(monkeypatch):
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(n_devices=6, model_parallel=4, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="requested 3 devices but only 2 available"):
        make_mesh(n_devices=3, devices=["cpu"] * 2)
    # no card here: asking for cards raises, and never falls back to the CPU
    with pytest.raises(ValueError, match="requested 2 devices but only 0 available"):
        make_mesh(n_devices=2)
    with pytest.raises(ValueError, match="requested all devices but only 0 available"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices but only 1 available"):
        make_mesh(n_devices=2)
    mesh = make_mesh(n_devices=1)
    assert [str(d) for d in mesh.devices.flat] == ["cuda:0"]


def test_shard_batch_gives_each_row_its_slice():
    mesh = make_mesh(devices=["cpu"] * 4)
    batch = {"x": np.arange(16 * 4, dtype=np.float32).reshape(16, 4),
             "y": torch.arange(16), "none": None}
    shards = shard_batch(batch, mesh)
    assert len(shards) == 4
    for r, s in enumerate(shards):
        assert s["x"].shape == (4, 4) and torch.equal(s["y"], torch.arange(4 * r, 4 * r + 4))
        np.testing.assert_array_equal(s["x"].numpy(), batch["x"][4 * r:4 * r + 4])
        assert s["none"] is None
    assert rank_rows(16, mesh) == slice(0, 4)
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch({"x": np.zeros((6, 2))}, mesh)


def test_replicate_makes_fresh_copies():
    mesh = make_mesh(devices=["cpu"] * 2)
    params = {"w": torch.ones(4, 4), "n": 3}
    reps = replicate(params, mesh)
    assert len(reps) == 2 and all(r["n"] == 3 for r in reps)
    reps[0]["w"].add_(1.0)  # an update of one copy moves neither the input nor the other
    assert torch.equal(params["w"], torch.ones(4, 4)) and torch.equal(reps[1]["w"], torch.ones(4, 4))
    model = torch.nn.Linear(3, 2)
    copies = replicate(model, mesh)
    assert all(c is not model and c.weight.data_ptr() != model.weight.data_ptr() for c in copies)
    assert torch.equal(copies[1].weight, model.weight)


def test_pad_to_multiple_tile_rows_and_layout():
    padded, n = pad_to_multiple(np.ones((5, 3)), 8)
    assert padded.shape == (8, 3) and n == 5 and padded[5:].sum() == 0
    padded2, n2 = pad_to_multiple(np.ones((8, 3)), 8)
    assert padded2.shape == (8, 3) and n2 == 8
    tiled = tile_rows({"a": np.arange(3)}, 8)["a"]  # the pad wraps past the rows
    np.testing.assert_array_equal(tiled, [0, 1, 2, 0, 1, 2, 0, 1])
    t = torch.arange(12.0).reshape(3, 4).t()
    out = canonicalize_layout({"a": t})
    assert out["a"].is_contiguous() and torch.equal(out["a"], t)


def test_one_device_mesh_and_a_ranks_items():
    mesh = one_device_mesh("cpu")
    assert mesh.shape == {DATA_AXIS: 1, MODEL_AXIS: 1} and mesh.group is None
    assert mesh.local_shards == [(0, torch.device("cpu"))]
    assert rank_items([7, 8, 9], mesh) == [7, 8, 9]
    grid = np.empty((2, 1), dtype=object)
    grid[:, 0] = [torch.device("cpu")] * 2
    ranks = [Mesh(grid, group=object(), rank=r, world_size=2) for r in range(2)]
    # 5 items pad to 6: from the first item, or by the last with repeat_last
    assert [rank_items(range(5), m) for m in ranks] == [[0, 1, 2], [3, 4, 0]]
    assert [rank_items(range(5), m, repeat_last=True) for m in ranks] == [[0, 1, 2], [3, 4, 4]]


def test_a_rank_loads_only_its_rows_of_a_streamed_batch():
    """``east_dataset.batch_iterator(select=)``: a rank's selection of each
    batch is what it loads, in order (the streamed EAST trainer's input)."""
    from manuscript_tpu_torch.train.east_dataset import batch_iterator

    class Items:
        def __init__(self):
            self.loaded = []

        def __len__(self):
            return 10

        def __getitem__(self, i):
            self.loaded.append(i)
            return np.full((2, 2, 3), i, np.uint8), np.zeros((1, 1)), np.zeros((1, 1, 8))

    grid = np.empty((2, 1), dtype=object)
    grid[:, 0] = [torch.device("cpu")] * 2
    rank1 = Mesh(grid, group=object(), rank=1, world_size=2)
    items = Items()
    batches = list(batch_iterator(items, 3, shuffle=False, select=lambda c: rank_items(c, rank1)))
    # batches [0, 1, 2], [3, 4, 5], [6, 7, 8], [9] pad to even sizes; rank 1 takes the second half
    assert [b["image"][:, 0, 0, 0].tolist() for b in batches] == [[2, 0], [5, 3], [8, 6], [9]]
    assert items.loaded == [2, 0, 5, 3, 8, 6, 9]


def test_global_draws_give_each_rank_the_one_device_rows():
    draw = lambda: rand_rows((6, 3, 2), torch.Generator().manual_seed(5), "cpu")
    whole = draw()
    x = torch.ones(6, 3, 2)
    mask = dropout(x, 0.5, torch.Generator().manual_seed(5), (6, 3, 1))
    for rank in range(3):
        with global_draws(rank, 3):
            part = rand_rows((2, 3, 2), torch.Generator().manual_seed(5), "cpu")
            mine = dropout(x[:2], 0.5, torch.Generator().manual_seed(5), (2, 3, 1))
        assert torch.equal(part, whole[2 * rank:2 * rank + 2])
        assert torch.equal(mine, mask[2 * rank:2 * rank + 2])
    assert torch.equal(draw(), whole)  # outside, a draw is the batch's own


def test_initialize_distributed_without_a_launcher_is_a_no_op(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    initialize_distributed()
    assert not torch.distributed.is_initialized()


def test_explicit_kwargs_failure_raises():
    """A misconfigured multi-process job fails loudly, not in one process."""
    code = textwrap.dedent("""
        import sys
        from datetime import timedelta
        sys.path.insert(0, sys.argv[1])
        from manuscript_tpu_torch.parallel import initialize_distributed
        try:
            initialize_distributed(init_method="tcp://127.0.0.1:1", world_size=2, rank=1,
                                   backend="gloo", timeout=timedelta(seconds=5))
        except Exception as e:
            print("RAISED", type(e).__name__, flush=True)
        else:
            print("SWALLOWED", flush=True)
    """)
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True,
                         timeout=120)
    assert "RAISED" in out.stdout, out.stdout + out.stderr


def _rank_collectives(mesh):
    """Each collective on a two-rank gloo group → rank 0's results."""
    rank = mesh.rank
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    y = sum_over_ranks(x * (rank + 1), mesh.group)  # [3, 6] on both ranks
    (y * torch.tensor([1.0, 10.0])).sum().backward()
    grads = average_gradients([torch.full((3,), float(rank)), torch.full((2, 2), 2.0 * rank)],
                              mesh.group)
    gathered = all_gather_rows(torch.full((2, 3), float(rank)), mesh)
    w = torch.full((4,), float(rank))
    broadcast_([w], mesh)
    # a BatchNorm over the ranks' halves of one batch, in train mode
    bn = BatchNorm(3)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 2.0, 3.0]))
    sync_batch_stats(bn, mesh.group)
    data = torch.from_numpy(np.random.default_rng(0).normal(2.0, 3.0, (4, 3, 5, 5)).astype(np.float32))
    half = data[rank_rows(4, mesh)].clone().requires_grad_(True)
    out = bn(half)
    # the global loss, as the trainers' losses are: the ranks' sums summed
    loss = sum_over_ranks((out * torch.arange(half.numel()).reshape(half.shape).float()).sum(),
                          mesh.group)
    loss.backward()
    return dict(y=y.detach(), x_grad=x.grad if x.grad is not None else None, grads=grads,
                gathered=gathered, w=w, bn_out=out.detach(), bn_grad=half.grad,
                running=(bn.running_mean.clone(), bn.running_var.clone()),
                weight_grad=average_gradients([bn.weight.grad], mesh.group)[0])


@pytest.fixture(scope="module")
def collectives():
    return spawn(_rank_collectives, make_mesh(devices=["cpu"] * 2))


def test_collectives_over_two_ranks(collectives):
    r = collectives
    torch.testing.assert_close(r["y"], torch.tensor([3.0, 6.0]))
    # each rank's copy of the global loss: the ranks' objectives sum to
    # world_size × it, and rank 0's gradient is that sum's
    torch.testing.assert_close(r["x_grad"], torch.tensor([2.0, 20.0]))
    grads = r["grads"]
    torch.testing.assert_close(grads[0], torch.full((3,), 0.5))
    torch.testing.assert_close(grads[1], torch.full((2, 2), 1.0))
    torch.testing.assert_close(r["gathered"], torch.tensor([[0.0] * 3] * 2 + [[1.0] * 3] * 2))
    torch.testing.assert_close(r["w"], torch.zeros(4))  # rank 0's value


def test_a_synchronised_batchnorm_is_the_whole_batchs(collectives):
    """Rank 0's half, its input gradient (over the world size: the ranks'
    objectives sum to 2 × the global loss), the running statistics and the
    weight's gradient (averaged over the ranks, as the trainers do) equal
    the BatchNorm's on the whole batch in one process."""
    bn = BatchNorm(3)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 2.0, 3.0]))
    data = torch.from_numpy(np.random.default_rng(0).normal(2.0, 3.0, (4, 3, 5, 5)).astype(np.float32))
    data.requires_grad_(True)
    out = bn(data)
    weights = torch.cat([torch.arange(out[:2].numel())] * 2).reshape(out.shape).float()
    (out * weights).sum().backward()
    r = collectives
    torch.testing.assert_close(r["bn_out"], out[:2].detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(r["bn_grad"] / 2, data.grad[:2], rtol=1e-5, atol=1e-5)
    for got, want in zip(r["running"], (bn.running_mean, bn.running_var)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(r["weight_grad"], bn.weight.grad, rtol=1e-5, atol=1e-5)
