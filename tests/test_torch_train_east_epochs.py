"""The port's whole EAST trainer held to the JAX trainer over many steps, on
the CPU.

Both packages' ``train`` run end to end at ``make_quality_ckpt``'s recipe,
cut to size: resnet50-micro, RAdam + Lookahead (k 5, α 0.5) under cosine
warm restarts (T_0 10 epochs), clip 5.0, no SAM, no multiscale, nothing
frozen, the GPU-resident dataset (``cache_device=True``), on four rendered
pages at 64², batch 2, 12 epochs: 24 steps, which span a warm restart (step
20), four Lookahead syncs (steps 5, 10, 15, 20), RAdam's rectified branch
(ρ_t ≥ 5 from step 6) and four validations (epochs 2, 5, 8, 11). Both start
from one set of weights, the JAX ``init`` of seed 0 carried across with
``params_from_jax``, and both take the device jitter as the identity (the
two packages draw it from different generators).

Held, at these tolerances:

* each epoch's training loss and each validation loss within 2e-4
  relative: the two loops sum in different orders and flax's BatchNorm
  takes its variance as E[x²] − E[x]², so they part by rounding, ~1e-5
  relative over these steps;
* the epoch of ``best.msgpack`` (the first validation loss that no later
  one beats), and both packages' ``best.msgpack`` files within the
  parameter bound below;
* the final running statistics within 1e-2 of each buffer's largest entry,
  ten times what the two loops part by here (~1e-3, in the deepest blocks,
  whose batch statistics follow the coordinates below);
* the final parameters (and ``best.msgpack``'s): each coordinate within
  D = Σ_t 2·η_t·r_t·B_t over RAdam's rectified steps, the farthest two
  float32 loops can part. RAdam moves a coordinate by η_t·r_t·m̂_t/(√v̂_t + ε)
  once ρ_t ≥ 5, and by η_t·m̂_t before: those first five updates are the
  gradients' momentum itself, which both loops compute alike up to
  rounding. A rectified update is normalised, so a coordinate whose
  gradient is rounding noise on both sides (one whose exact gradient is
  nearly 0) is pushed a full step either way; its size is at most
  η_t·r_t·B_t, with B_t = (1 − β1)/(1 − β1^t)·√((1 − β2^t)/(1 − β2))·
  √(Σ_{k<t} (β1²/β2)^k) the largest |m̂_t|/√v̂_t (Cauchy–Schwarz over the
  moments' sums), so two loops part by at most twice that a step.
  Lookahead's sync replaces the fast weights by a convex combination of
  fast and slow ones, which cannot widen a gap. Over these 24 steps
  D ≈ 1.4e-3; the two loops part by ~0.2·D.

The bound catches a wrong loop: the port without Lookahead, and the port
with BatchNorm momentum 0.99 (flax's is 0.9), each fail it. A run resumed
from a JAX trainer's state file at epoch 0 is the run that starts from its
weights. The JAX ``train`` compiles once, in a module fixture (~10 s); each
port run takes about a second.
"""

from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manuscript_tpu.models.east import EASTModel as JaxEASTModel
from manuscript_tpu.train import east_train as JT
from manuscript_tpu.train.optim import build_east_optimizer as jax_east_optimizer
from manuscript_tpu_torch.models.layers import BatchNorm
from manuscript_tpu_torch.train import east_train as PT
from manuscript_tpu_torch.train.optim import build_east_optimizer
from manuscript_tpu_torch.utils.synthetic import build_page_dataset
from manuscript_tpu_torch.utils.weights import params_from_jax, params_to_jax

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

EPOCHS, VAL_INTERVAL, PAGES, BATCH = 12, 3, 4, 2
RECIPE = dict(backbone="resnet50-micro", target_size=64, epochs=EPOCHS, batch_size=BATCH, lr=1e-3,
              grad_clip=5.0, use_sam=False, use_lookahead=True, use_multiscale=False,
              freeze_first=False, early_stop=150, val_interval=VAL_INTERVAL,
              log_tensorboard=False, ckpt_interval=1, cache_device=True, seed=0)
LOSS_REL = 2e-4
STATS_REL = 1e-2
STEPS_PER_EPOCH = PAGES // BATCH


@pytest.fixture(scope="module")
def pages(tmp_path_factory):
    root = tmp_path_factory.mktemp("pages")
    coco, img_dir, _ = build_page_dataset(root, PAGES, seed=0, page_h=256, page_w=192, n_rows=3,
                                          n_cols=1)
    return img_dir, coco


@pytest.fixture(scope="module")
def jax_run(pages, tmp_path_factory):
    """The JAX trainer's run (its own ``init`` of seed 0), the jitter off."""
    img_dir, coco = pages
    root = tmp_path_factory.mktemp("jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "_device_color_jitter", lambda img, key: img)
        out = JT.train(img_dir, coco, img_dir, coco, experiment_root=str(root), n_devices=1,
                       **RECIPE)
    jm = JaxEASTModel(backbone="resnet50-micro", dtype=jnp.float32)
    start = jm.init(jax.random.PRNGKey(RECIPE["seed"]), jnp.zeros((1, 64, 64, 3), jnp.float32))
    best = flax.serialization.msgpack_restore(
        (Path(out["exp_dir"]) / "checkpoints" / "best.msgpack").read_bytes())
    return dict(out, start=jax.tree_util.tree_map(np.asarray, dict(start)), best=best)


def port_run(pages, root, start, bn_momentum=None, **over):
    """The port's run from the JAX ``init`` (``start``), the jitter off."""
    img_dir, coco = pages

    def init_from_jax(model, seed):
        model.load_state_dict(params_from_jax(start))
        for m in model.modules():
            if bn_momentum is not None and isinstance(m, BatchNorm):
                m.momentum = bn_momentum
        return model

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PT, "init_random_", init_from_jax)
        mp.setattr(PT, "device_color_jitter", lambda img, gen, rows=None: img)
        out = PT.train(img_dir, coco, img_dir, coco, experiment_root=str(root), device="cpu",
                       **dict(RECIPE, **over))
    best = flax.serialization.msgpack_restore(
        (Path(out["exp_dir"]) / "checkpoints" / "best.msgpack").read_bytes())
    return dict(out, final=params_to_jax(out["model"].state_dict()), best=best)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def best_epoch(history):
    vals = [(h["val_loss"], h["epoch"]) for h in history if "val_loss" in h]
    return min(vals, key=lambda v: v[0])[1]  # the first of equal minima: only a drop replaces it


def drift_bound(n_steps: int) -> float:
    """D of the module docstring over the first ``n_steps`` steps: the
    farthest a coordinate of two float32 runs of RAdam at this schedule can
    part (r_t and the threshold as ``optim.scale_by_radam`` takes them)."""
    _, schedule = build_east_optimizer(RECIPE["lr"], STEPS_PER_EPOCH, use_sam=False)
    b1, b2 = 0.9, 0.999
    rho_inf = 2 / (1 - b2) - 1
    total = 0.0
    for t in range(1, n_steps + 1):
        rho = rho_inf - 2 * t * b2**t / (1 - b2**t)
        if rho >= 5:
            r = np.sqrt((rho - 4) * (rho - 2) * rho_inf / ((rho_inf - 4) * (rho_inf - 2) * rho))
            moments = np.sqrt(sum((b1 * b1 / b2) ** k for k in range(t)))
            b = (1 - b1) / (1 - b1**t) * np.sqrt((1 - b2**t) / (1 - b2)) * moments
            total += 2 * float(schedule(t - 1)) * r * b
    return total


def gaps(jax_out, port_out) -> dict:
    """Each held quantity's gap over its bound (≤ 1 within it)."""
    jh, ph = jax_out["history"], port_out["history"]
    rel = lambda a, b: abs(a - b) / abs(a)

    def param_gap(want, got, epoch):
        w, g = _leaves(want["params"]), _leaves(got["params"])
        return max(np.abs(g[k] - w[k]).max() for k in w) / drift_bound((epoch + 1) * STEPS_PER_EPOCH)

    def stats_gap(want, got):
        w, g = _leaves(want["batch_stats"]), _leaves(got["batch_stats"])
        return max(np.abs(g[k] - w[k]).max() / (STATS_REL * np.abs(w[k]).max()) for k in w)

    return {
        "train_loss": max(rel(j["train_loss"], p["train_loss"]) for j, p in zip(jh, ph)) / LOSS_REL,
        "val_loss": max(rel(j["val_loss"], p["val_loss"])
                        for j, p in zip(jh, ph) if "val_loss" in j) / LOSS_REL,
        "best_epoch": 0.0 if best_epoch(jh) == best_epoch(ph) else np.inf,
        "params": param_gap(jax_out, port_out["final"], EPOCHS - 1),
        "best_params": param_gap(jax_out["best"], port_out["best"], best_epoch(jh)),
        "running_stats": stats_gap(jax_out, port_out["final"]),
    }


def test_the_port_trainer_holds_to_the_jax_trainer_over_epochs(pages, jax_run, tmp_path):
    port = port_run(pages, tmp_path, jax_run["start"])
    g = gaps(jax_run, port)
    print("gaps over their bounds", g)
    for j, p in zip(jax_run["history"], port["history"]):
        print(j["epoch"], j["train_loss"], p["train_loss"], j.get("val_loss"), p.get("val_loss"),
              j["lr"], p["lr"])
    assert [h["epoch"] for h in port["history"]] == list(range(EPOCHS))
    assert all(v <= 1.0 for v in g.values()), g


def test_the_run_spans_a_restart_lookahead_syncs_rectification_and_validations(jax_run):
    hist = jax_run["history"]
    lrs = [h["lr"] for h in hist]
    steps = EPOCHS * STEPS_PER_EPOCH
    restarts = [e for e in range(1, EPOCHS) if lrs[e] > lrs[e - 1]]
    beta2 = 0.999
    rho_inf = 2 / (1 - beta2) - 1
    rho = lambda t: rho_inf - 2 * t * beta2**t / (1 - beta2**t)
    assert restarts and steps // 5 >= 2
    assert rho(6) >= 5 > rho(5) and steps >= 6
    assert sum("val_loss" in h for h in hist) >= 2


@pytest.mark.parametrize("wrong", [dict(use_lookahead=False), dict(bn_momentum=0.99)],
                         ids=["no_lookahead", "bn_momentum_0.99"])
def test_the_bound_fails_a_wrong_loop(pages, jax_run, tmp_path, wrong):
    g = gaps(jax_run, port_run(pages, tmp_path, jax_run["start"], **wrong))
    print(wrong, "gaps over their bounds", g)
    assert max(g.values()) > 1.0, g


def test_a_resume_from_a_jax_state_file_trains_from_its_weights(pages, jax_run, tmp_path):
    """A JAX trainer's state file at epoch 0 (its optimizer state has JAX's
    layout, so the port starts a fresh one) resumes into the run that starts
    from its weights, over 8 steps: the fresh state, Lookahead's copy of the
    starting weights included, is built from the loaded weights, not from the
    random ones they replace (which the first sync, at step 5, would pull the
    weights halfway back to)."""
    img_dir, coco = pages
    start = jax_run["start"]
    tx, _ = jax_east_optimizer(RECIPE["lr"], STEPS_PER_EPOCH, use_sam=False)
    path = tmp_path / "jax_state.msgpack"
    path.write_bytes(flax.serialization.to_bytes({
        "params": start["params"], "batch_stats": start["batch_stats"],
        "opt_state": tx.init(start["params"]), "ema_params": start["params"],
        "meta": {"epoch": 0, "global_step": 0, "best_val_loss": float("inf"), "patience": 0}}))
    short = dict(RECIPE, epochs=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PT, "device_color_jitter", lambda img, gen, rows=None: img)
        resumed = PT.train(img_dir, coco, img_dir, coco, experiment_root=str(tmp_path / "resumed"),
                           device="cpu", resume_from=str(path), **short)
    direct = port_run(pages, tmp_path / "direct", start, epochs=4)
    np.testing.assert_allclose([h["train_loss"] for h in resumed["history"]],
                               [h["train_loss"] for h in direct["history"]], rtol=1e-6)
    for k, v in direct["model"].state_dict().items():
        torch.testing.assert_close(resumed["model"].state_dict()[k], v, rtol=1e-6, atol=1e-7)
