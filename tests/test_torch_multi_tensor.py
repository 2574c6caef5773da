"""The EAST step's fused optimizer work (``ops/multi_tensor.py``) on the CPU.

The plain twins against the loops they replace: SAM/ASAM's perturbation
and restore as ``optim.sam_gradient`` ran them leaf by leaf, and the
reference of the guarded clip → SGD → apply (``multi_tensor_twin``)
against ``guard_finite``, ``chain(clip, sgd)`` and ``apply_updates``; bit
for bit, in float32, float64 and bfloat16. The whole ASAM train step,
whose update is ``optim.apply_step``, with the fused ``step`` against the
same step through ``tx.update``. The chunk
table the kernels walk (``plan``, ``walk``) and the layouts they gather
(``strided_offset``, ``_table``). The route: CPU leaves run the plain loops
and the transforms and open no ``optim.multi_tensor`` region; other devices
and mixes raise. The kernels themselves are held to the twins on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from manuscript_tpu_torch.models.east import EASTModel
from manuscript_tpu_torch.ops import multi_tensor as mt
from manuscript_tpu_torch.train import east_train, optim
from manuscript_tpu_torch.train.optim import guard_finite
from manuscript_tpu_torch.utils import profiling
from multi_tensor_twin import clip_sgd_apply_twin

SIZES = [1, 3, 512, 4097, 2**20 + 5]
SHAPES = [(7,), (16, 3, 3, 3), (5, 4), (1,), (33,)]


def _leaves(dtype, seed=0, scale=1.0, shapes=SHAPES):
    g = torch.Generator().manual_seed(seed)
    params = [torch.randn(s, generator=g).to(dtype) for s in shapes]
    grads = [(torch.randn(s, generator=g) * scale).to(dtype) for s in shapes]
    return params, grads


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.float32: torch.int32, torch.float64: torch.int64,
                   torch.bfloat16: torch.int16}[t.dtype])


def _same_bits(got, want):
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _loops_perturb(params, grads, rho, adaptive):
    """``sam_gradient``'s perturbation as the port ran it before the kernels."""
    scaled = [torch.abs(p) * g for p, g in zip(params, grads)] if adaptive else grads
    scale = rho / (torch.sqrt(sum(torch.sum(torch.square(t)) for t in scaled)) + 1e-12)
    e_w = ([torch.square(p) * g * scale for p, g in zip(params, grads)] if adaptive
           else [g * scale for g in grads])
    saved = [p.detach().clone() for p in params]
    for p, e in zip(params, e_w):
        p.copy_(p + e)
    return saved


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("adaptive", [True, False])
def test_perturb_and_restore_twin_equal_the_loops(adaptive, dtype):
    params, grads = _leaves(dtype)
    want = [p.clone() for p in params]
    want_saved = _loops_perturb(want, grads, 0.05, adaptive)
    before = [p.clone() for p in params]
    saved = mt.perturb(params, grads, 0.05, adaptive)
    _same_bits(params, want)
    _same_bits(saved, want_saved)
    assert not all(torch.equal(p, b) for p, b in zip(params, before))
    mt.restore(params, saved)
    _same_bits(params, before)


@pytest.mark.parametrize("adaptive", [True, False])
def test_perturb_twin_given_a_norm_uses_it(adaptive):
    """The card tests hand the twin the kernel's own norm: given the norm it
    would compute, the twin computes what it computes alone; given another,
    it scales by that one."""
    params, grads = _leaves(torch.float32, seed=3)
    scaled = [torch.abs(p) * g for p, g in zip(params, grads)] if adaptive else grads
    norm = mt.global_norm(scaled)
    alone, given, other = ([p.clone() for p in params] for _ in range(3))
    mt.perturb_plain(alone, grads, 0.05, adaptive)
    mt.perturb_plain(given, grads, 0.05, adaptive, norm=norm)
    mt.perturb_plain(other, grads, 0.05, adaptive, norm=norm * 2)
    _same_bits(given, alone)
    assert not torch.equal(other[1], alone[1])


def test_global_norm_is_within_a_millionth_of_the_float64_norm():
    _, grads = _leaves(torch.float32, seed=4, shapes=[(n,) for n in SIZES])
    want = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
    got = mt.global_norm(grads)
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)


@pytest.mark.parametrize("sam_adaptive", [True, False])
def test_sam_gradient_runs_the_loops_arithmetic(sam_adaptive):
    """``optim.sam_gradient`` through the twin against the same two passes
    written with the loops: equal loss and gradients, parameters restored."""
    torch.manual_seed(0)
    x = torch.randn(4, 6)
    params, _ = _leaves(torch.float32, seed=5, shapes=[(6, 5), (5,), (3, 3, 2)])
    params = [p.requires_grad_() for p in params]
    before = [p.detach().clone() for p in params]

    def loss_fn():
        return (torch.tanh(x @ params[0] + params[1]) ** 2).sum() + 0.1 * (params[2] ** 2).sum()

    loss, grads = optim.sam_gradient(loss_fn, params, rho=0.05, adaptive=sam_adaptive)
    g1 = torch.autograd.grad(loss_fn(), params)
    with torch.no_grad():
        saved = _loops_perturb(params, list(g1), 0.05, sam_adaptive)
    want_loss = loss_fn()
    want = torch.autograd.grad(want_loss, params)
    with torch.no_grad():
        for p, s in zip(params, saved):
            p.copy_(s)
    _same_bits([loss.detach()], [want_loss.detach()])
    _same_bits(grads, want)
    _same_bits([p.detach() for p in params], before)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("loss_value,scale", [
    (1.5, 0.1),  # under the clip
    (1.5, 10.0),  # clipped
    (float("nan"), 10.0),  # guarded: every gradient zeroed, the trace decays
    (float("inf"), 0.1),
])
def test_fused_update_twin_equals_guard_transforms_and_apply(loss_value, scale, dtype):
    """Three steps of the update's reference (``clip_sgd_apply_twin``, which
    the card holds the kernel to) and of ``clip_sgd_step`` against
    guard_finite → chain(clip, sgd).update → apply_updates: the same
    parameters, traces, count and state keys, bit for bit; with a
    non-finite loss no NaN reaches them."""
    tx, schedule = optim.build_east_optimizer(0.5, 2, use_sam=True, grad_clip=5.0, t_0=1)
    assert tx.step is not None
    keys = ["w", "b", "k"]
    params, _ = _leaves(dtype, seed=6, shapes=[(6, 5), (5,), (3, 3, 2)])
    fused = dict(zip(keys, params))
    plain = {k: p.clone() for k, p in fused.items()}
    twin = {k: p.clone() for k, p in fused.items()}
    twin_trace = {k: torch.zeros_like(p) for k, p in fused.items()}
    s_fused, s_plain = tx.init(fused), tx.init(plain)
    for step in range(3):
        _, grads = _leaves(dtype, seed=10 + step, scale=scale, shapes=[(6, 5), (5,), (3, 3, 2)])
        grads = dict(zip(keys, grads))
        loss = torch.tensor(loss_value if step == 1 else 2.0, dtype=dtype)
        s_fused = tx.step(loss, grads, s_fused, fused)
        updates, s_plain = tx.update(guard_finite(loss, grads), s_plain, plain)
        optim.apply_updates(plain, updates)
        clip_sgd_apply_twin(loss, [grads[k] for k in keys], [twin_trace[k] for k in keys],
                            [twin[k] for k in keys], 5.0, -schedule(step), 0.9)
        trace_f, trace_p = s_fused["1"]["0"]["trace"], s_plain["1"]["0"]["trace"]
        for got, trace in ((fused, trace_f), (twin, twin_trace)):
            _same_bits([got[k] for k in keys], [plain[k] for k in keys])
            _same_bits([trace[k] for k in keys], [trace_p[k] for k in keys])
    assert s_fused["1"]["1"]["count"] == s_plain["1"]["1"]["count"] == 3
    assert s_fused.keys() == s_plain.keys() == {"0", "1"} and s_fused["0"] == {}
    assert s_fused["1"].keys() == {"0", "1"} and s_fused["1"]["0"].keys() == {"trace"}
    assert all(torch.isfinite(p).all() for p in fused.values())


def test_fused_update_is_in_place_and_reads_the_count_before_it_increments():
    """The parameters change in place, by −lr at the count before it
    increments (on a card the trace too: tests/test_torch_cuda.py)."""
    tx, schedule = optim.build_east_optimizer(0.5, 2, use_sam=True, grad_clip=1e9, t_0=1)
    params = {"w": torch.zeros(4)}
    w = params["w"]
    state = tx.init(params)
    state["1"]["1"]["count"] = 5
    out = tx.step(torch.tensor(1.0), {"w": torch.ones(4)}, state, params)
    assert torch.equal(out["1"]["0"]["trace"]["w"], torch.ones(4))
    assert out["1"]["1"]["count"] == 6
    assert params["w"] is w and torch.equal(w, torch.full((4,), -schedule(5)))


def _micro_step_state(tx):
    torch.manual_seed(0)
    model = EASTModel("resnet50-micro")
    mask = east_train.freeze_mask(model, True)
    trainable = {k: p for k, p in model.named_parameters() if mask[k]}
    return east_train.EASTTrainState(model, tx.init(trainable), None), trainable


def _micro_batch(seed):
    g = torch.Generator().manual_seed(seed)
    image = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8, generator=g)
    score = (torch.rand(2, 16, 16, generator=g) > 0.7).float()
    return image, score, torch.randn(2, 16, 16, 8, generator=g) * 4


def test_asam_train_step_fused_equals_the_transforms(tmp_path):
    """Three ASAM steps of the micro detector, whose update is
    ``optim.apply_step``: with the fused ``step`` (it runs once a step) and
    with the same transform without one (``optim.composed_step``: guard,
    ``tx.update``, ``apply_updates``): equal parameters, running statistics, traces and
    counts; the frozen leaves untouched; the state through
    ``last_state.msgpack`` and back."""
    tx, _ = optim.build_east_optimizer(1e-2, 2, use_sam=True)
    fused_steps = []
    counted = tx._replace(step=lambda *args: fused_steps.append(1) or tx.step(*args))
    composed = tx._replace(step=None)
    fused, trainable = _micro_step_state(tx)
    plain, trainable_p = _micro_step_state(composed)
    start = {k: p.detach().clone() for k, p in fused.model.named_parameters()}
    frozen = [k for k in start if k not in trainable]
    assert frozen and trainable
    for step in range(3):
        batch = _micro_batch(step)
        loss_f = east_train.train_step(fused, counted, trainable, *batch)
        loss_p = east_train.train_step(plain, composed, trainable_p, *batch)
        _same_bits([loss_f], [loss_p])
    assert len(fused_steps) == 3
    _same_bits(list(fused.model.state_dict().values()), list(plain.model.state_dict().values()))
    trace_f, trace_p = fused.opt_state["1"]["0"]["trace"], plain.opt_state["1"]["0"]["trace"]
    assert trace_f.keys() == trace_p.keys() == trainable.keys()
    _same_bits(list(trace_f.values()), [trace_p[k] for k in trace_f])
    assert fused.opt_state["1"]["1"]["count"] == plain.opt_state["1"]["1"]["count"] == 3
    now = {k: p.detach() for k, p in fused.model.named_parameters()}
    _same_bits([now[k] for k in frozen], [start[k] for k in frozen])
    assert all(not torch.equal(now[k], start[k]) for k in trainable if k.endswith("conv1.weight"))
    path = tmp_path / "last_state.msgpack"
    path.write_bytes(fused.serialize())
    back, _ = _micro_step_state(tx)
    back.load(path)
    _same_bits([back.opt_state["1"]["0"]["trace"][k] for k in trace_f], list(trace_f.values()))
    assert back.opt_state["1"]["1"]["count"] == 3


def _covered(pl, numels, aligned=lambda g, leaf, start: True):
    """How often each element of each leaf is walked, and the elements the
    walk takes as float4s."""
    seen = [np.zeros(n, np.int64) for n in numels]
    vector = [np.zeros(n, bool) for n in numels]
    for grp in pl.groups:
        for chunk in range(grp.chunks):
            for leaf, s, v, e in mt.walk(grp, chunk, lambda lf, st: aligned(grp, lf, st)):
                assert s <= v <= e and (v - s) % 4 == 0
                seen[grp.first + leaf][s:e] += 1
                vector[grp.first + leaf][s:v] = True
    return seen, vector


@pytest.mark.parametrize("numels", [SIZES, SIZES[::-1], [0, 5, 0, 2**15, 2**15 + 1, 0],
                                    [3] * 1100, [2**20 + 5] + [1] * 600])
def test_plan_walks_every_element_exactly_once(numels):
    pl = mt.plan(tuple(numels))
    assert sum(g.last - g.first for g in pl.groups) == len(numels)
    assert all(g.last - g.first <= mt.MAX_LEAVES for g in pl.groups)
    assert len(pl.groups) == -(-len(numels) // mt.MAX_LEAVES)
    assert pl.chunks == sum(g.chunks for g in pl.groups)
    for grp in pl.groups:
        assert (grp.offsets % mt.ALIGN == 0).all() and (np.diff(grp.offsets) >= grp.numels).all()
        assert grp.chunks == -(-int(grp.offsets[-1]) // mt.CHUNK)
    assert pl.flat == sum(int(g.offsets[-1]) for g in pl.groups)
    seen, vector = _covered(pl, numels)
    assert all((s == 1).all() for s in seen)
    # aligned leaves go by float4s but for the last n % 4 elements of each piece
    assert all(v.sum() >= n - 4 * -(-n // mt.CHUNK) for v, n in zip(vector, numels))


def test_plan_walks_views_with_a_storage_offset_one_float_at_a_time():
    """Leaves that are views into one buffer at odd storage offsets: the
    walk still covers each element once; a piece goes by float4s exactly
    when the parameter's address at its start is 16-byte aligned."""
    base = torch.zeros(sum(SIZES) + 64)
    views, at = [], 0
    for i, n in enumerate(SIZES):
        at += i % 4  # gaps of 0 to 3 floats between the leaves
        views.append(base[at:at + n])
        at += n
    assert [v.storage_offset() % 4 for v in views] != [0] * len(views)
    numels = [v.numel() for v in views]
    pl = mt.plan(tuple(numels))

    def aligned(grp, leaf, start):
        return (views[grp.first + leaf].data_ptr() + 4 * start) % 16 == 0

    seen, vector = _covered(pl, numels, aligned)
    assert all((s == 1).all() for s in seen)
    for v, vec in zip(views, vector):
        assert vec.any() == (v.data_ptr() % 16 == 0 and v.numel() >= 4)


@pytest.mark.parametrize("shape", [(4, 3, 3, 3), (2, 5, 7, 1), (3, 1, 2, 2), (6, 4, 1, 1)])
def test_grad_offset_follows_channels_last_strides(shape):
    """The kernels gather a channels_last tensor through (c, hw): each
    row-major element's storage offset, a permutation of the leaf; a
    tensor that is row-major as well is read as row-major."""
    g = torch.empty(shape).contiguous(memory_format=torch.channels_last)
    o, c, h, w = shape
    table = mt._table([[torch.empty(shape)], [g]], [True, False])
    idx = np.arange(g.numel()).reshape(shape)
    want = [int(np.dot(np.unravel_index(i, shape), g.stride())) for i in idx.ravel()]
    if g.is_contiguous():
        assert table.strided[0] == 0 and (int(table.c[0]), int(table.hw[0])) == (1, 1)
        assert want == list(range(g.numel()))
        return
    assert table.strided[0] == 2 and (int(table.c[0]), int(table.hw[0])) == (c, h * w)
    got = [mt.strided_offset(i, c, h * w) for i in range(g.numel())]
    assert got == want and sorted(got) == list(range(g.numel()))


@pytest.mark.parametrize("written", [True, False])
def test_table_reads_other_layouts_only_where_it_may_copy(written):
    """A tensor that is neither row-major nor channels_last: a gradient
    (only read) is copied to row-major, a parameter or trace (written in
    place) is refused; channels_last parameters and traces are gathered
    and scattered through their layout (their bit of ``strided``)."""
    p = torch.randn(4, 6)
    odd = torch.randn(6, 4).t()  # a transposed view
    cl = torch.randn(2, 3, 2, 2).contiguous(memory_format=torch.channels_last)
    if written:
        with pytest.raises(ValueError, match="neither row-major nor channels_last"):
            mt._table([[odd], [p]], [True, False])
        table = mt._table([[cl], [cl.contiguous()], [cl]], [True, False, True])
        assert table.strided.tolist() == [0b101] and (table.c[0], table.hw[0]) == (3, 4)
        return
    table = mt._table([[p], [odd]], [True, False])
    assert table.strided.tolist() == [0] and table.ptrs[1][0] != odd.data_ptr()
    with pytest.raises(ValueError, match="shape"):
        mt._table([[p], [cl]], [True, False])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_leaves_off_the_card_take_the_twin(monkeypatch, tmp_path, dtype):
    """CPU leaves of any dtype run the plain loops and the transforms: no
    kernel, no region; the kernels' own route refuses them."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel route ran on the CPU")

    for name in ("perturb_cuda", "restore_cuda", "clip_sgd_apply_cuda"):
        monkeypatch.setattr(mt, name, refuse)
    params, grads = _leaves(dtype)
    traces = [torch.zeros_like(p) for p in params]
    loss = torch.tensor(1.0, dtype=dtype)
    assert not mt.on_card(params, grads, traces, loss=loss)
    tx, _ = optim.build_east_optimizer(0.5, 2, use_sam=True)
    keys = [str(i) for i in range(len(params))]
    before = mt.kernel_launches
    with profiling.trace(tmp_path) as prof:
        saved = mt.perturb(params, grads, 0.05, True)
        mt.restore(params, saved)
        tx.step(loss, dict(zip(keys, grads)), tx.init(dict(zip(keys, params))),
                dict(zip(keys, params)))
    assert mt.kernel_launches == before and isinstance(saved, list)
    names = {e.name for e in prof.events() if e.is_user_annotation}
    assert "optim.multi_tensor" not in names
    with pytest.raises(ValueError, match="CPU"):
        mt.clip_sgd_apply(loss, grads, traces, params, 5.0, -0.1, 0.9)


def test_on_card_refuses_devices_and_mixes_the_kernels_cannot_take():
    cpu, meta = [torch.zeros(3)], [torch.empty(3, device="meta")]
    assert not mt.on_card(cpu, cpu)
    assert not mt.on_card([], [])
    with pytest.raises(ValueError, match="CUDA card"):
        mt.on_card(meta, meta)  # neither the CPU nor a card
    with pytest.raises(ValueError, match="CUDA card"):
        mt.on_card(meta, cpu)  # a mix
    with pytest.raises(ValueError, match="CUDA card"):
        mt.on_card(cpu, cpu, loss=torch.empty((), device="meta"))
