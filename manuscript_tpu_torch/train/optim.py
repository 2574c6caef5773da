"""Optimizers with optax's arithmetic (counterpart of
``manuscript_tpu/train/optim.py``), as functional transforms over dicts of
tensors keyed by parameter name.

A ``GradientTransformation`` is optax's pair ``init(params) → state`` and
``update(updates, state, params) → (updates, state)``; states are nested
dicts of tensors and Python ints (step counts live on the host, so no step
ever waits for the card), which ``utils.weights.msgpack_serialize`` writes.
Where optax and ``torch.optim`` differ, this module follows optax:

* ``clip_by_global_norm``: g unchanged below the norm, else (g / ‖g‖)·max,
  with no ε;
* ``sgd``: a trace ``t ← g + 0.9·t`` scaled by −lr;
* ``adam``/``adamw``: ε outside the square root, bias corrections by
  1 − βᵗ; AdamW adds ``wd·p`` before the −lr scale, so the decay is scaled
  by the learning rate;
* ``radam``: optax's rectification with its threshold of 5.0 on ρ;
* learning-rate schedules are evaluated at the transform's count *before*
  it increments, in float32 as optax evaluates them;
* freezing: the trainers hand a transform the trainable leaves only, so the
  frozen ones get no update and hold no state, and the clip's global norm
  covers the trainable leaves, as under ``optax.masked``. (``optax.masked``
  passes the frozen leaves' raw gradients through as their updates, which
  the JAX trainers then add to the weights: the port gives them no update,
  which is what a freeze means.)

``sam_gradient`` is SAM/ASAM's two gradient passes, ``lookahead`` a
terminal transform, ``ema_update`` the parameter average.
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.layers import frozen_batch_stats
from ..parallel.mesh import average_gradients
from ..utils.profiling import annotate

Tensors = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _zeros(params: Tensors) -> Tensors:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return {str(i): t.init(params) for i, t in enumerate(transforms)}

    def update(updates, state, params=None):
        new_state = {}
        for i, t in enumerate(transforms):
            updates, new_state[str(i)] = t.update(updates, state[str(i)], params)
        return updates, new_state

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(updates, state, params=None):
        norm = global_norm(list(updates.values()))
        keep = norm < max_norm
        return {k: torch.where(keep, u, (u / norm) * max_norm) for k, u in updates.items()}, state

    return GradientTransformation(lambda params: {}, update)


def trace(decay: float) -> GradientTransformation:
    def update(updates, state, params=None):
        new = {k: u + decay * state["trace"][k] for k, u in updates.items()}
        return new, {"trace": new}

    return GradientTransformation(lambda params: {"trace": _zeros(params)}, update)


def _bias_correction(decay: float, count: int) -> float:
    """1 − decay^count in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def _moments(updates, state, b1, b2):
    mu = {k: (1 - b1) * u + b1 * state["mu"][k] for k, u in updates.items()}
    nu = {k: (1 - b2) * torch.square(u) + b2 * state["nu"][k] for k, u in updates.items()}
    return mu, nu, state["count"] + 1


def _adam_init(params):
    return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    def update(updates, state, params=None):
        mu, nu, count = _moments(updates, state, b1, b2)
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        out = {k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps) for k in updates}
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(_adam_init, update)


def scale_by_radam(
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, threshold: float = 5.0
) -> GradientTransformation:
    ro_inf = 2.0 / (1.0 - b2) - 1.0

    def update(updates, state, params=None):
        mu, nu, count = _moments(updates, state, b1, b2)
        f32 = np.float32
        b2t = f32(b2) ** f32(count)
        ro = f32(ro_inf) - f32(2) * f32(count) * b2t / (f32(1) - b2t)
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        if ro >= threshold:
            r = float(np.sqrt((ro - f32(4)) * (ro - f32(2)) * f32(ro_inf)
                              / ((f32(ro_inf) - f32(4)) * (f32(ro_inf) - f32(2)) * ro)))
            out = {k: r * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps) for k in updates}
        else:
            out = {k: mu[k] / c1 for k in updates}
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(_adam_init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params=None):
        return {k: u + weight_decay * params[k] for k, u in updates.items()}, state

    return GradientTransformation(lambda params: {}, update)


def scale_by_learning_rate(lr: Union[float, Schedule]) -> GradientTransformation:
    """−lr · updates; a schedule is read at the count before it increments."""
    if not callable(lr):
        return GradientTransformation(
            lambda params: {}, lambda updates, state, params=None: (
                {k: -lr * u for k, u in updates.items()}, state)
        )

    def update(updates, state, params=None):
        step = -lr(state["count"])
        return {k: step * u for k, u in updates.items()}, {"count": state["count"] + 1}

    return GradientTransformation(lambda params: {"count": 0}, update)


def sgd(lr, momentum: float = 0.9) -> GradientTransformation:
    return chain(trace(momentum), scale_by_learning_rate(lr))


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(lr))


def adamw(lr, weight_decay: float = 1e-4) -> GradientTransformation:
    return chain(scale_by_adam(), add_decayed_weights(weight_decay), scale_by_learning_rate(lr))


def radam(lr) -> GradientTransformation:
    return chain(scale_by_radam(), scale_by_learning_rate(lr))


def lookahead(k: int = 5, alpha: float = 0.5) -> GradientTransformation:
    """Terminal transform: every k-th update the slow weights move
    α·(fast − slow) and the fast weights jump to them."""

    def init(params):
        return {"slow": {n: p.detach().clone() for n, p in params.items()}, "step": 0}

    def update(updates, state, params=None):
        step = state["step"] + 1
        fast = {n: params[n] + u for n, u in updates.items()}
        if step % k:
            return {n: fast[n] - params[n] for n in updates}, {"slow": state["slow"], "step": step}
        slow = {n: s + alpha * (fast[n] - s) for n, s in state["slow"].items()}
        return {n: slow[n] - params[n] for n in updates}, {"slow": slow, "step": step}

    return GradientTransformation(init, update)


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors, scale: Optional[float] = None) -> None:
    """params += updates (· scale), in place."""
    for k, p in params.items():
        p.add_(updates[k] if scale is None else updates[k] * scale)


@torch.no_grad()
def ema_update(ema: Tensors, params: Tensors, decay: float = 0.999) -> None:
    """ema ← decay·ema + (1 − decay)·params, in place."""
    for k, e in ema.items():
        e.copy_(decay * e + (1.0 - decay) * params[k].detach())


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule, in float32."""
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(min(float(count), float(decay_steps)))
        cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay_steps)))
        return float(f32(init_value) * (f32(1 - alpha) * cos + f32(alpha)))

    return schedule


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    def schedule(count: int) -> float:
        i = sum(count >= b for b in boundaries)
        return schedules[i](count - (boundaries[i - 1] if i else 0))

    return schedule


def cosine_warm_restarts(
    base_lr: float,
    t_0: int,
    steps_per_epoch: int,
    n_cycles: int = 16,
    t_mult: int = 1,
    eta_min_ratio: float = 0.01,
) -> Schedule:
    """CosineAnnealingWarmRestarts: cosine decays of T_0·steps_per_epoch
    steps (times t_mult each cycle), joined."""
    schedules, boundaries, total, length = [], [], 0, t_0 * steps_per_epoch
    for _ in range(n_cycles):
        schedules.append(cosine_decay_schedule(base_lr, max(length, 1), eta_min_ratio))
        total += length
        boundaries.append(total)
        length *= t_mult
    return join_schedules(schedules, boundaries[:-1])


def gradients(loss: torch.Tensor, params: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """d loss / d params, zeros for parameters the loss does not reach. With
    a process ``group`` (data-parallel training; ``loss`` the global batch's,
    through ``parallel.sum_over_ranks``) the ranks' gradients are averaged,
    which gives the global batch's gradient on every rank."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return average_gradients([torch.zeros_like(p) if g is None else g
                              for p, g in zip(params, grads)], group)


def sam_gradient(
    loss_fn: Callable[[], torch.Tensor],
    params: Sequence[torch.Tensor],
    rho: float = 0.05,
    adaptive: bool = True,
    model: Optional[torch.nn.Module] = None,
    group=None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """SAM (``adaptive=False``) or ASAM → (loss at params + e_w, gradients at
    params + e_w); the caller's optimizer applies them at ``params``.

    e_w = (p² if adaptive else 1)·g·ρ/(‖(|p| if adaptive else 1)·g‖ + 1e-12),
    with g the gradient at ``params``. The first pass (at ``params``) moves
    the BatchNorms' running statistics of ``model``; the perturbed pass runs
    under ``frozen_batch_stats`` and leaves them alone. Profiler regions:
    ``sam.first_pass`` (the gradient at ``params`` and the perturbation) and
    ``sam.second_pass`` (the gradient at the perturbed point, the restore).
    With a process ``group`` both gradients are the global batch's
    (``gradients``), so every rank takes the same ε."""
    params = list(params)
    with annotate("sam.first_pass"):
        g1 = gradients(loss_fn(), params, group)
        with torch.no_grad():
            scaled = [torch.abs(p) * g for p, g in zip(params, g1)] if adaptive else g1
            scale = rho / (global_norm(scaled) + 1e-12)
            e_w = ([torch.square(p) * g * scale for p, g in zip(params, g1)] if adaptive
                   else [g * scale for g in g1])
            saved = [p.detach().clone() for p in params]
            for p, e in zip(params, e_w):
                p.copy_(p + e)
    with annotate("sam.second_pass"):
        try:
            with frozen_batch_stats(model) if model is not None else nullcontext():
                loss2 = loss_fn()
                g2 = gradients(loss2, params, group)
        finally:
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
    return loss2, g2


def build_east_optimizer(
    lr: float,
    steps_per_epoch: int,
    use_sam: bool = True,
    use_lookahead: bool = True,
    grad_clip: float = 5.0,
    t_0: int = 10,
) -> Tuple[GradientTransformation, Schedule]:
    """EAST: clip → SGD(momentum 0.9) for SAM, else clip → RAdam (→
    Lookahead); cosine warm restarts either way."""
    schedule = cosine_warm_restarts(lr, t_0, steps_per_epoch)
    if use_sam:
        return chain(clip_by_global_norm(grad_clip), sgd(schedule, 0.9)), schedule
    tx = chain(clip_by_global_norm(grad_clip), radam(schedule))
    if use_lookahead:
        tx = chain(tx, lookahead(5, 0.5))
    return tx, schedule


def build_trba_optimizer(
    optimizer: str,
    lr: float,
    weight_decay: float = 0.0,
    grad_clip: Optional[float] = None,
    schedule: Optional[Schedule] = None,
) -> GradientTransformation:
    lr_or_sched = schedule if schedule is not None else lr
    if optimizer == "adam":
        base = adam(lr_or_sched)
    elif optimizer == "adamw":
        base = adamw(lr_or_sched, weight_decay)
    elif optimizer == "sgd":
        base = sgd(lr_or_sched, 0.9)
    else:
        raise ValueError(f"Unknown optimizer: {optimizer}")
    return chain(clip_by_global_norm(grad_clip), base) if grad_clip else base
