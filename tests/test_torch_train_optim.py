"""The port's optimizers (``manuscript_tpu_torch/train/optim.py``) against
optax and the JAX package's transforms over 6 steps from the same parameters
and gradients (numpy, from a seed).

Tolerances: SGD within 1e-6 absolute; Adam, AdamW, RAdam and the stacks
built on them agree within 1e-4·lr per step on the entries whose gradient
exceeds 1e-6 in magnitude (Adam divides by √ν, which amplifies the rounding
of tiny gradients); schedules within 1e-7 relative; SAM/ASAM's perturbed
loss and gradient within 1e-5 relative. Frozen leaves get no update in the
port (the trainers optimize the trainable leaves only); under optax's
``masked`` they get their raw gradient, which the JAX trainers add to the
weights — the test pins both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from manuscript_tpu.train import optim as J
from manuscript_tpu_torch.train import optim as P
from manuscript_tpu_torch.train.checkpoints import OrbaxCheckpointer

SHAPES = {"w": (6, 5), "b": (5,), "k": (3, 3, 2)}
N_STEPS = 6


def _params(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, 1, s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(seed: int = 1, scale: float = 1.0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_STEPS):
        g = {k: (rng.normal(0, scale, s)).astype(np.float32) for k, s in SHAPES.items()}
        g["w"][0, :2] = np.float32(1e-8)  # tiny entries, left out of the Adam checks
        out.append(g)
    return out


def _run_jax(tx, params, grads):
    """→ [(updates, params after them)] per step; the update jitted, as the
    JAX trainers run it (eager float32 powers round differently)."""
    state = tx.init(params)
    update = jax.jit(tx.update)
    traj = []
    for g in grads:
        updates, state = update(g, state, params)
        params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates))
        traj.append(({k: np.asarray(u) for k, u in updates.items()}, params))
    return traj


def _run_port(tx, params, grads):
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = tx.init(p)
    traj = []
    for g in grads:
        updates, state = tx.update({k: torch.from_numpy(v) for k, v in g.items()}, state, p)
        P.apply_updates(p, updates)
        traj.append(({k: u.numpy().copy() for k, u in updates.items()},
                     {k: v.numpy().copy() for k, v in p.items()}))
    return traj


def _check(jtraj, ptraj, grads, atol, big_only=False, keys=None):
    """Each step's updates within ``atol``."""
    for step, ((ju_all, _), (pu_all, _)) in enumerate(zip(jtraj, ptraj), 1):
        for k in keys or SHAPES:
            ju, pu = ju_all[k], pu_all[k]
            sel = np.ones(ju.shape, bool)
            if big_only:
                sel = np.all([np.abs(g[k]) > 1e-6 for g in grads], axis=0)
            np.testing.assert_allclose(pu[sel], ju[sel], rtol=0, atol=atol, err_msg=f"{k} step {step}")


def test_sgd_momentum():
    params, grads = _params(), _grads()
    _check(_run_jax(optax.sgd(0.1, momentum=0.9), params, grads),
           _run_port(P.sgd(0.1, 0.9), params, grads), grads, atol=1e-6)


@pytest.mark.parametrize("name", ["adam", "adamw", "radam"])
def test_adam_family(name):
    lr = 1e-3
    params, grads = _params(), _grads()
    jtx = {"adam": optax.adam(lr), "adamw": optax.adamw(lr, weight_decay=1e-2),
           "radam": optax.radam(lr)}[name]
    ptx = {"adam": P.adam(lr), "adamw": P.adamw(lr, 1e-2), "radam": P.radam(lr)}[name]
    _check(_run_jax(jtx, params, grads), _run_port(ptx, params, grads), grads,
           atol=1e-4 * lr, big_only=True)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm(scale):
    params, grads = _params(), _grads(scale=scale)
    _check(_run_jax(optax.chain(optax.clip_by_global_norm(5.0), optax.sgd(0.1)), params, grads),
           _run_port(P.chain(P.clip_by_global_norm(5.0), P.sgd(0.1, 0.0)), params, grads),
           grads, atol=1e-6)


@pytest.mark.parametrize("use_sam", [True, False])
def test_build_east_optimizer(use_sam):
    """SGD(0.9) under a clip, or clip → RAdam → Lookahead (k=5: step 5 syncs),
    both on cosine warm restarts."""
    lr = 1e-2
    params, grads = _params(), _grads(scale=3.0)
    jtx, jsched = J.build_east_optimizer(lr, 2, use_sam=use_sam, grad_clip=5.0, t_0=1)
    ptx, psched = P.build_east_optimizer(lr, 2, use_sam=use_sam, grad_clip=5.0, t_0=1)
    atol = 1e-6 if use_sam else 1e-4 * lr
    _check(_run_jax(jtx, params, grads), _run_port(ptx, params, grads), grads, atol=atol,
           big_only=not use_sam)
    for step in range(12):
        assert psched(step) == pytest.approx(float(jsched(step)), rel=1e-7)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_apply_step_runs_the_fused_step_and_refuses_a_scale_for_it(monkeypatch, scale):
    """``apply_step`` on a transform with a fused ``step`` (EAST's SAM route)
    runs that step at scale 1; at any other scale it raises and leaves the
    parameters and the state alone, and the composed update does not run in
    the fused step's place."""
    tx, _ = P.build_east_optimizer(1e-2, 2, use_sam=True)
    fused, composed = [], []
    counted = tx._replace(step=lambda *args: fused.append(1) or tx.step(*args))
    real = P.composed_step
    monkeypatch.setattr(P, "composed_step", lambda *a, **k: composed.append(1) or real(*a, **k))
    params = {k: torch.from_numpy(v) for k, v in _params().items()}
    start = {k: v.clone() for k, v in params.items()}
    grads = {k: torch.from_numpy(v) for k, v in _grads()[0].items()}
    state = counted.init(params)
    if scale == 1.0:
        state = P.apply_step(counted, torch.tensor(1.0), grads, state, params, scale)
        assert fused == [1] and state["1"]["1"]["count"] == 1
        assert all(not torch.equal(params[k], start[k]) for k in params)
        return
    with pytest.raises(ValueError, match="fused step"):
        P.apply_step(counted, torch.tensor(1.0), grads, state, params, scale)
    assert fused == [] and composed == [] and state["1"]["1"]["count"] == 0
    assert all(torch.equal(params[k], start[k]) for k in params)


def test_apply_step_without_a_fused_step_scales_the_composed_update():
    """Without a ``step``: params += ``tx.update``'s result · scale, and no
    update at all when the loss is not finite."""
    tx = P.sgd(0.1, 0.0)
    params = {k: torch.from_numpy(v) for k, v in _params().items()}
    start = {k: v.clone() for k, v in params.items()}
    grads = {k: torch.from_numpy(v) for k, v in _grads()[0].items()}
    state = P.apply_step(tx, torch.tensor(float("nan")), grads, tx.init(params), params, 0.5)
    assert all(torch.equal(params[k], start[k]) for k in params)
    P.apply_step(tx, torch.tensor(1.0), grads, state, params, 0.5)
    for k in params:
        assert torch.equal(params[k], start[k] + (-0.1 * grads[k]) * 0.5)


def test_lookahead_syncs_like_the_jax_transform():
    params, grads = _params(), _grads()
    jtx = optax.chain(optax.sgd(0.05), J.lookahead(k=3, alpha=0.5))
    ptx = P.chain(P.sgd(0.05, 0.0), P.lookahead(3, 0.5))
    _check(_run_jax(jtx, params, grads), _run_port(ptx, params, grads), grads, atol=1e-6)


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_build_trba_optimizer(name):
    lr = 1e-3
    params, grads = _params(), _grads(scale=4.0)
    sched = optax.cosine_decay_schedule(lr, 10, alpha=0.01)
    jtx = J.build_trba_optimizer(name, lr, 1e-2, 5.0, sched)
    ptx = P.build_trba_optimizer(name, lr, 1e-2, 5.0, P.cosine_decay_schedule(lr, 10, alpha=0.01))
    _check(_run_jax(jtx, params, grads), _run_port(ptx, params, grads), grads,
           atol=1e-6 if name == "sgd" else 1e-4 * lr, big_only=name != "sgd")
    with pytest.raises(ValueError):
        P.build_trba_optimizer("lamb", lr)


def test_freezing_by_trainable_subset_matches_optax_masked():
    """The trainers hand a transform the trainable leaves only: equal to
    optax.masked on them, with the clip's norm over them only; frozen leaves
    stay put in the port and take +g in the JAX stack."""
    lr = 1e-3
    params, grads = _params(), _grads(scale=4.0)
    mask = {"w": True, "b": False, "k": True}
    jtx = optax.masked(optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr)), mask)
    jtraj = _run_jax(jtx, params, grads)
    keep = lambda tree: {k: v for k, v in tree.items() if mask[k]}
    ptraj = _run_port(P.chain(P.clip_by_global_norm(1.0), P.adam(lr)), keep(params),
                      [keep(g) for g in grads])
    _check(jtraj, ptraj, grads, atol=1e-4 * lr, big_only=True, keys=["w", "k"])
    np.testing.assert_allclose(jtraj[-1][1]["b"], params["b"] + sum(g["b"] for g in grads),
                               rtol=0, atol=1e-5)


def test_ema_update():
    params, grads = _params(0), _params(1)
    ref = J.ema_update(params, grads, 0.9)
    ema = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    P.ema_update(ema, {k: torch.from_numpy(v) for k, v in grads.items()}, 0.9)
    for k in SHAPES:
        np.testing.assert_allclose(ema[k].numpy(), np.asarray(ref[k]), rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("t_0,spe,t_mult", [(2, 3, 1), (1, 4, 2)])
def test_cosine_warm_restarts_at_every_step_of_three_cycles(t_0, spe, t_mult):
    jsched = J.cosine_warm_restarts(0.1, t_0, spe, n_cycles=3, t_mult=t_mult)
    psched = P.cosine_warm_restarts(0.1, t_0, spe, n_cycles=3, t_mult=t_mult)
    total = sum(t_0 * spe * t_mult**i for i in range(3))
    for step in range(total + 3):
        assert psched(step) == pytest.approx(float(jsched(step)), rel=1e-7, abs=1e-9), step


def _sam_loss_jax(p, x):
    return jnp.sum(jnp.tanh(x @ p["w"] + p["b"]) ** 2) + 0.1 * jnp.sum(p["k"] ** 2)


@pytest.mark.parametrize("adaptive", [True, False])
def test_sam_gradient(adaptive):
    params = _params(2)
    x = np.random.default_rng(3).normal(0, 1, (4, 6)).astype(np.float32)
    jl, jg = J.sam_gradient(_sam_loss_jax, params, x, rho=0.05, adaptive=adaptive)
    p = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x)
    loss_fn = lambda: (torch.tanh(xt @ p["w"] + p["b"]) ** 2).sum() + 0.1 * (p["k"] ** 2).sum()
    pl, pg = P.sam_gradient(loss_fn, list(p.values()), rho=0.05, adaptive=adaptive)
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-5)
    for (k, v), g in zip(p.items(), pg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(v.detach().numpy(), params[k])  # restored


def test_step_indexed_checkpointer_keeps_the_newest(tmp_path):
    ck = OrbaxCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    template = {"w": torch.zeros(3), "meta": {"step": 0, "loss": 0.0}}
    for step in (1, 5, 9):
        ck.save(step, {"w": torch.full((3,), float(step)), "meta": {"step": step, "loss": step / 2}})
    assert ck.all_steps() == [5, 9] and ck.latest_step() == 9
    got = ck.restore(template)
    assert torch.equal(got["w"], torch.full((3,), 9.0)) and got["meta"] == {"step": 9, "loss": 4.5}
    assert ck.restore(template, step=5)["meta"]["step"] == 5
    ck.close()
    with pytest.raises(FileNotFoundError):
        OrbaxCheckpointer(str(tmp_path / "empty")).restore(template)
