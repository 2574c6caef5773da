"""EAST training (counterpart of ``manuscript_tpu/train/east_train.py``).

``train(train_images, train_anns, val_images, val_anns, ...)`` keeps the JAX
trainer's defaults (``resnet101``, 1024², batch 3, ASAM + SGD, OHEM, focal
geometry, multiscale, ``freeze_first``), files and step semantics:

* the step: SAM or ASAM (``optim.sam_gradient``: the descent gradient taken
  at params + e_w over *all* parameters, the frozen ones too, and applied
  at params; the loss returned at the perturbed point; the BatchNorm
  running statistics moved once, by the unperturbed pass) or one plain
  gradient; the non-finite guard that zeroes the gradients and still steps
  the optimizer; the update of the trainable parameters (under SAM the
  optimizer's fused ``step``: the kernels of ``ops.multi_tensor`` on a
  card, the trace and the parameters updated in place); EMA of the
  parameters when ``use_ema``;
* cosine warm restarts stepped per optimizer update; RAdam + Lookahead when
  ``use_sam`` is off;
* multiscale: each batch at ``_snap32(target_size · f)`` for f drawn from
  ``MULTISCALE_FACTORS``; predicted maps that then differ from the label
  maps are resized to them inside the gradient with antialiased bilinear
  (``jax.image.resize``'s "bilinear" antialiases when it shrinks);
* ``cache_device=True``: ``DeviceDataset`` keeps the whole rasterized
  dataset on the card; a step ships only its indices, and the gather, the
  photometric jitter and the resize run there. Otherwise batches stream
  from ``east_dataset.batch_iterator`` with the resize on the host (the
  port's byte-equal INTER_LINEAR);
* validation every ``val_interval`` epochs (loss and soft dice, with the EMA
  weights when ``use_ema``); ``best.msgpack`` on improvement,
  ``last.msgpack`` and ``last_state.msgpack`` every ``ckpt_interval``
  epochs and at the end or an early stop.

The weights files are flax msgpack ({"params", "batch_stats"}): the port's
and the JAX package's ``EAST`` load them. By design, unlike the JAX trainer:
frozen parameters get no update (optax's ``masked`` passes their raw
gradients through, and the JAX trainer adds them to the weights); the
optimizer state of ``last_state.msgpack`` has the port's layout, so a JAX
state file resumes its weights, EMA and counters and keeps a fresh optimizer
state (``EASTTrainState.load``). TensorBoard gets the scalars and, each
validation, the collage of ``utils/visualize.create_collage`` for sample 0
of the first validation batch (the EMA weights' prediction when
``use_ema``). ``device=None`` is the card.

Data parallelism (``n_devices`` > 1, a ``mesh``, or an initialised process
group) runs one process per data row, as ``trba_train`` does: the weights
broadcast from rank 0 at the start and after a resume; each rank's slice of
each global batch (padded to a multiple of the ranks by tiling its rows, as
the JAX trainer pads), with ``DeviceDataset`` gathering the rank's rows on
its card and the streamed path reading, augmenting and resizing only them
(the host augmentation streams seeded from (seed, rank), so they differ from
a one-device run's by design); BatchNorm's statistics,
every numerator and denominator of the loss and of the soft dice, the
gradients (both of SAM's passes) global; rank 0 writes the checkpoints and
TensorBoard, behind a barrier after each epoch. Each epoch's log holds
``host_s``, the seconds this process waited for its training batches.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..models.east import EASTModel
from ..models.layers import sync_batch_stats
from ..ops.image import normalize_u8, resize_u8
from ..parallel.mesh import (
    DATA_AXIS,
    Mesh,
    barrier,
    broadcast_,
    rank_items,
    rank_rows,
    spawn,
    tile_rows,
)
from ..utils.device import resolve_device
from ..utils.profiling import annotate
from ..utils.weights import (
    init_random_,
    msgpack_restore,
    msgpack_serialize,
    params_from_jax,
    params_to_jax,
)
from .checkpoints import restore_tree
from .east_dataset import ConcatDataset, EASTDataset, batch_iterator
from .losses import east_loss, soft_dice_coefficient
from .optim import apply_step, build_east_optimizer, ema_update, gradients, sam_gradient
from .trba_train import data_parallel_mesh, one_rank_per_row, rank_seed, timed

MULTISCALE_FACTORS = (0.8, 0.9, 1.0, 1.1, 1.2)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, C, H, W) → (B, C, h, w) half-pixel bilinear, antialiased when it
    shrinks: ``jax.image.resize(..., "bilinear")``."""
    if x.shape[-2:] == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=True)


def device_color_jitter(img: torch.Tensor, generator: torch.Generator,
                        brightness: float = 0.5, contrast: float = 0.5,
                        saturation: float = 0.5, rows=None) -> torch.Tensor:
    """Per-sample brightness, contrast and saturation of (B, H, W, 3) float
    images on their device (``color_jitter`` without the hue rotation).
    ``rows`` = (slice, n): ``img`` holds those rows of a batch of n, whose
    factors are drawn for all n."""
    rows, n = rows or (slice(None), img.shape[0])

    def factor(r):
        u = torch.rand((n, 1, 1, 1), generator=generator, device=img.device)[rows]
        return (1 - r) + 2 * r * u

    out = img * factor(brightness)
    mean = out.mean(dim=(1, 2, 3), keepdim=True)
    out = (out - mean) * factor(contrast) + mean
    gray = out.mean(dim=3, keepdim=True)
    return gray + (out - gray) * factor(saturation)


class DeviceDataset:
    """A dataset resident on the card: its (image u8, score, geometry)
    arrays, rasterized without host augmentation, are uploaded once; a batch
    is a gather by index, the photometric jitter (when ``augment``) and the
    resize to ``side``, all on the device. With a ``mesh`` (one process per
    data row) the indices repeat from the first up to a multiple of the data
    axis and the rank gathers its slice of them; the jitter's factors are
    drawn for the whole batch, so each row gets the one-device draw."""

    def __init__(self, dataset, device: torch.device, augment: bool, seed: int = 0,
                 mesh: Optional[Mesh] = None):
        subs = getattr(dataset, "datasets", [dataset])
        saved = [getattr(d, "augment", False) for d in subs]
        for d in subs:
            d.augment = False
        try:
            items = [dataset[i] for i in range(len(dataset))]
        finally:
            for d, flag in zip(subs, saved):
                d.augment = flag
        self.device = device
        self.images = torch.from_numpy(np.stack([it[0] for it in items])).to(device)
        self.scores = torch.from_numpy(np.stack([it[1] for it in items])).to(device)
        self.geos = torch.from_numpy(np.stack([it[2] for it in items])).to(device)
        self.augment = augment
        self.seed = seed
        self.mesh = mesh
        self.base_side = int(self.images.shape[1])

    def __len__(self) -> int:
        return int(self.images.shape[0])

    def batch(self, idx, side: Optional[int] = None, step: int = 0):
        """(image u8 (B, side, side, 3), score, geometry) of samples ``idx``."""
        side = side or self.base_side
        idx = np.asarray(idx, np.int64)
        rows = slice(0, len(idx))
        if self.mesh is not None:
            idx = tile_rows({"i": idx}, self.mesh.shape[DATA_AXIS])["i"]
            rows = rank_rows(len(idx), self.mesh)
        im = self.images[torch.as_tensor(idx[rows], device=self.device)].float()
        if self.augment:
            gen = torch.Generator(device=self.device).manual_seed(self.seed * 1_000_003 + step)
            im = device_color_jitter(im, gen, rows=(rows, len(idx)))
        if side != self.base_side:
            im = resize_bilinear(im.permute(0, 3, 1, 2), side, side).permute(0, 2, 3, 1)
        idx = torch.as_tensor(idx[rows], device=self.device)
        return im.clamp(0.0, 255.0).to(torch.uint8), self.scores[idx], self.geos[idx]


def _snap32(x: float) -> int:
    return max(32, int(round(x / 32)) * 32)


def _as_list(x) -> List:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def freeze_mask(model: EASTModel, freeze_first: bool) -> Dict[str, bool]:
    """Parameter name → trainable: the backbone's conv1, bn1 and layer1
    freeze when ``freeze_first``."""
    frozen = ("conv1", "bn1", "layer1_")

    def trainable(name: str) -> bool:
        keys = name.split(".")
        return not (freeze_first and keys[0] == "backbone" and keys[1].startswith(frozen))

    return {name: trainable(name) for name, _ in model.named_parameters()}


class EASTTrainState:
    """What a resume needs: the model (its parameters and running
    statistics), the optimizer state, the EMA of the parameters (None when
    off) and the counters."""

    def __init__(self, model: EASTModel, opt_state, ema: Optional[Dict[str, torch.Tensor]],
                 epoch: int = 0, global_step: int = 0, best_val_loss: float = float("inf"),
                 patience: int = 0):
        self.model = model
        self.opt_state = opt_state
        self.ema = ema
        self.epoch = epoch
        self.global_step = global_step
        self.best_val_loss = best_val_loss
        self.patience = patience

    def weights(self, use_ema: bool = False) -> Dict[str, Any]:
        """{"params", "batch_stats"} in flax layout (EMA parameters when
        ``use_ema``)."""
        state = dict(self.model.state_dict())
        if use_ema and self.ema is not None:
            state.update(self.ema)
        return params_to_jax(state)

    def serialize(self) -> bytes:
        payload = self.weights()
        payload["opt_state"] = self.opt_state
        payload["ema_params"] = self.weights(use_ema=True)["params"]
        payload["meta"] = {"epoch": self.epoch, "global_step": self.global_step,
                           "best_val_loss": self.best_val_loss, "patience": self.patience}
        return msgpack_serialize(payload)

    def load(self, data: Union[bytes, Path],
             fresh_opt_state: Optional[Callable[[], Any]] = None) -> "EASTTrainState":
        """Tolerant restore: the weights and counters must load; an optimizer
        state or EMA of another layout (another optimizer, or a JAX state
        file) is kept fresh with a warning. The fresh optimizer state is
        ``fresh_opt_state()``, called once the weights are loaded, since
        Lookahead's state holds a copy of the weights it starts from (a state
        built before the load would pull the weights back toward the ones
        they replaced at its first sync); without it, the state held."""
        raw = msgpack_restore(data)
        self.model.load_state_dict(params_from_jax(raw))
        try:
            self.opt_state = restore_tree(self.opt_state, raw["opt_state"])
        except (ValueError, KeyError, TypeError) as e:
            print(f"[EAST.train] opt_state restore failed ({e}); keeping fresh")
            if fresh_opt_state is not None:
                self.opt_state = fresh_opt_state()
        if self.ema is not None:
            try:
                ema = params_from_jax({"params": raw["ema_params"]})
                for k, t in self.ema.items():
                    t.copy_(ema[k].reshape(t.shape))
            except (ValueError, KeyError, TypeError, RuntimeError) as e:
                print(f"[EAST.train] ema_params restore failed ({e}); keeping fresh")
        meta = raw["meta"]
        self.epoch = int(meta["epoch"])
        self.global_step = int(meta["global_step"])
        self.best_val_loss = float(meta["best_val_loss"])
        self.patience = int(meta["patience"])
        return self


def east_train_loss(model: EASTModel, image_u8, gt_score, gt_geo, use_ohem: bool,
                    ohem_ratio: float, use_focal_geo: bool, focal_gamma: float,
                    group=None) -> torch.Tensor:
    """The training loss of one batch (with a process ``group``, of the
    global batch whose slice this is), in the model's current mode and its
    parameters' dtype. Profiler region ``east.forward``."""
    with annotate("east.forward"):
        out = model(normalize_u8(image_u8, next(model.parameters()).dtype))
        pred_score, pred_geo = out["score"][..., 0], out["geometry"]
        gh, gw = gt_score.shape[1], gt_score.shape[2]
        if pred_score.shape[1:3] != (gh, gw):  # multiscale: back to the label maps' size
            pred_score = resize_bilinear(pred_score[:, None], gh, gw)[:, 0]
            pred_geo = resize_bilinear(pred_geo.permute(0, 3, 1, 2), gh, gw).permute(0, 2, 3, 1)
        return east_loss(gt_score, pred_score, gt_geo, pred_geo, use_ohem=use_ohem,
                         ohem_ratio=ohem_ratio, use_focal_geo=use_focal_geo,
                         focal_gamma=focal_gamma, group=group)


def train_step(state: EASTTrainState, tx, trainable: Dict[str, torch.Tensor], image, score, geo,
               use_sam: bool = True, sam_adaptive: bool = True, use_ohem: bool = True,
               ohem_ratio: float = 0.5, use_focal_geo: bool = True, focal_gamma: float = 2.0,
               ema_decay: float = 0.999, group=None) -> torch.Tensor:
    """One optimizer step in place on ``state`` → the loss (at the perturbed
    point under SAM), on the device. With a process ``group`` the batch is
    this rank's slice and the loss and gradients are the global batch's (the
    model's BatchNorms synchronised by ``models.layers.sync_batch_stats``).
    Profiler regions: ``east.step`` around SAM's ``sam.first_pass`` and
    ``sam.second_pass`` (``east.gradient`` without SAM), then
    ``east.update``; each pass holds an ``east.forward`` (the loss) and an
    ``optim.backward``. The update is ``optim.apply_step``: with the SAM
    route's fused clip → SGD, on a card the momentum trace and the
    parameters are updated in place."""
    model = state.model
    model.train()
    loss_fn = lambda: east_train_loss(model, image, score, geo, use_ohem, ohem_ratio,
                                      use_focal_geo, focal_gamma, group)
    with annotate("east.step"):
        if use_sam:
            named = dict(model.named_parameters())
            loss, g_all = sam_gradient(loss_fn, named.values(), rho=0.05, adaptive=sam_adaptive,
                                       model=model, group=group)
            g_all = dict(zip(named, g_all))
            grads = {k: g_all[k] for k in trainable}
        else:
            with annotate("east.gradient"):
                loss = loss_fn()
                grads = dict(zip(trainable, gradients(loss, list(trainable.values()), group)))
        with annotate("east.update"):
            state.opt_state = apply_step(tx, loss, grads, state.opt_state, trainable)
            if state.ema is not None:
                ema_update(state.ema, dict(model.named_parameters()), ema_decay)
        return loss.detach()


def eval_step(model: EASTModel, image, score, geo, group=None):
    """(loss, soft dice, predicted score (B, h, w), predicted geometry
    (B, h, w, 8)) of a validation batch in eval mode; the loss and the dice
    of the global batch with a process ``group``."""
    model.eval()
    out = model(normalize_u8(image))
    pred_score = out["score"][..., 0]
    return (east_loss(score, pred_score, geo, out["geometry"], group=group),
            soft_dice_coefficient(score, pred_score, group), pred_score, out["geometry"])


@contextmanager
def _ema_weights(model: EASTModel, ema: Optional[Dict[str, torch.Tensor]]):
    """Inside: the model's parameters hold the EMA's values."""
    if ema is None:
        yield
        return
    params = dict(model.named_parameters())
    saved = {k: p.detach().clone() for k, p in params.items()}
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(ema[k])
    try:
        yield
    finally:
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved[k])


def _val_collage(dataset, raw, pred_score: torch.Tensor, pred_geo: torch.Tensor) -> np.ndarray:
    """The collage of sample 0 of a validation batch: from the host batch
    ``raw``, or (device-resident validation, ``raw`` None) the dataset's
    item 0, which is that sample."""
    from ..utils.visualize import create_collage

    if raw is None:
        im0, sc0, geo0, quads0 = dataset[0]
    else:
        im0, sc0, geo0 = raw["image"][0], raw["score"][0], raw["geo"][0]
        quads0 = raw.get("quads", [None])[0]
    return create_collage(im0, sc0, geo0, gt_quads=quads0,
                          pred_score=pred_score.float().cpu().numpy(),
                          pred_geo=pred_geo.float().cpu().numpy())


def _resolve_resume_path(resume_from: Union[str, Path]) -> Optional[Path]:
    """An experiment folder, its checkpoints folder, or a state file."""
    p = Path(resume_from)
    if p.is_file():
        return p
    for cand in (p / "last_state.msgpack", p / "checkpoints" / "last_state.msgpack"):
        if cand.exists():
            return cand
    return None


def _rank_main(mesh: Mesh, args: tuple, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    out = train(*args, **kwargs, mesh=mesh)
    sync_batch_stats(out["model"], None)  # the group ends with this process
    out["model"] = out["model"].cpu()
    out["ema_params"] = None if out["ema_params"] is None else {
        k: v.cpu() for k, v in out["ema_params"].items()}
    return out


def train(
    train_images: Union[str, Path, Sequence],
    train_anns: Union[str, Path, Sequence],
    val_images: Union[str, Path, Sequence],
    val_anns: Union[str, Path, Sequence],
    *,
    experiment_root: str = "./experiments",
    model_name: str = "resnet_quad",
    backbone: str = "resnet101",
    pretrained_backbone: bool = False,
    freeze_first: bool = True,
    target_size: int = 1024,
    score_geo_scale: Optional[float] = None,
    epochs: int = 500,
    batch_size: int = 3,
    lr: float = 1e-3,
    grad_clip: float = 5.0,
    early_stop: int = 100,
    use_sam: bool = True,
    sam_type: str = "asam",
    use_lookahead: bool = True,
    use_ema: bool = False,
    ema_decay: float = 0.999,
    use_multiscale: bool = True,
    use_ohem: bool = True,
    ohem_ratio: float = 0.5,
    use_focal_geo: bool = True,
    focal_gamma: float = 2.0,
    resume_from: Optional[Union[str, Path]] = None,
    val_interval: int = 1,
    device=None,
    mesh=None,
    n_devices: Optional[int] = None,
    log_tensorboard: bool = True,
    cache_device: bool = False,
    ckpt_interval: int = 1,
    seed: int = 0,
) -> Dict[str, Any]:
    """High-level EAST training → {"model", "ema_params", "best_val_loss",
    "exp_dir", "history"}. ``device=None`` is the card; ``n_devices`` or
    ``mesh`` train data-parallel (module docstring).
    ``pretrained_backbone`` is accepted and ignored, as in the JAX package
    (nothing is downloaded)."""
    mesh = data_parallel_mesh(n_devices, mesh, device)
    if mesh is not None and mesh.group is None and mesh.shape[DATA_AXIS] > 1:
        kwargs = {k: v for k, v in locals().items()
                  if k not in ("train_images", "train_anns", "val_images", "val_anns", "mesh",
                               "n_devices", "device")}
        out = spawn(_rank_main, one_rank_per_row(mesh),
                    (train_images, train_anns, val_images, val_anns), kwargs)
        first = mesh.devices[0, 0]
        out["model"] = out["model"].to(first)
        if out["ema_params"] is not None:
            out["ema_params"] = {k: v.to(first) for k, v in out["ema_params"].items()}
        return out
    group = None if mesh is None else mesh.group
    lead = mesh is None or mesh.rank == 0  # writes the files
    dev = resolve_device(device) if mesh is None else mesh.local_shards[0][1]
    score_geo_scale = score_geo_scale or 0.25
    exp_dir = Path(experiment_root) / model_name
    ckpt_dir = exp_dir / "checkpoints"
    ckpt_dir.mkdir(parents=True, exist_ok=True)

    train_sets = [EASTDataset(im, an, target_size=target_size, score_geo_scale=score_geo_scale,
                              augment=True, seed=rank_seed(seed, mesh) + i)
                  for i, (im, an) in enumerate(zip(_as_list(train_images), _as_list(train_anns)))]
    val_sets = [EASTDataset(im, an, target_size=target_size, score_geo_scale=score_geo_scale,
                            augment=False)
                for im, an in zip(_as_list(val_images), _as_list(val_anns))]
    train_ds = ConcatDataset(train_sets)
    steps_per_epoch = max(1, len(train_ds) // batch_size)

    model = init_random_(EASTModel(backbone), seed).to(dev)
    sync_batch_stats(model, group)
    tx, schedule = build_east_optimizer(lr, steps_per_epoch, use_sam=use_sam,
                                        use_lookahead=use_lookahead, grad_clip=grad_clip)
    mask = freeze_mask(model, freeze_first)
    trainable = {}
    for name, p in model.named_parameters():
        # SAM perturbs every parameter, the frozen ones too: all need gradients
        p.requires_grad_(use_sam or mask[name])
        if mask[name]:
            trainable[name] = p
    ema = ({k: p.detach().clone() for k, p in model.named_parameters()} if use_ema else None)
    state = EASTTrainState(model, tx.init(trainable), ema)
    if resume_from is not None:
        rp = _resolve_resume_path(resume_from)
        if rp is not None:
            state.load(rp, lambda: tx.init(trainable))
            print(f"[EAST.train] resumed from {rp} at epoch {state.epoch}")
        else:
            print(f"[EAST.train] resume requested but no state found at {resume_from}")
    if mesh is not None:  # every rank starts from rank 0's weights and EMA
        broadcast_(list(model.state_dict().values())
                   + ([] if state.ema is None else list(state.ema.values())), mesh)

    dev_train = dev_vals = None
    if cache_device:
        dev_train = DeviceDataset(train_ds, dev, augment=True, seed=seed, mesh=mesh)
        dev_vals = [DeviceDataset(vs, dev, augment=False, mesh=mesh) for vs in val_sets]

    writer = None
    if log_tensorboard and lead:
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(log_dir=str(exp_dir / "tb"))
        except Exception:
            writer = None

    ms_rng = np.random.default_rng(seed)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev, non_blocking=True)

    # the streamed path loads this rank's rows of each batch padded to the ranks
    own_rows = None if mesh is None else (lambda idx: rank_items(idx, mesh))

    def host_batch(batch, scale: float = 1.0):
        img = batch["image"]
        if scale != 1.0:
            side = _snap32(img.shape[1] * scale)
            img = np.stack([resize_u8(im, side, side) for im in img])
        return up(img), up(batch["score"]), up(batch["geo"])

    def train_batches(epoch: int):
        if dev_train is not None:
            perm = np.random.default_rng(seed + epoch).permutation(len(dev_train))
            for b in range(len(dev_train) // batch_size):
                scale = float(ms_rng.choice(MULTISCALE_FACTORS)) if use_multiscale else 1.0
                yield dev_train.batch(perm[b * batch_size:(b + 1) * batch_size],
                                      side=_snap32(target_size * scale), step=state.global_step)
        else:
            for batch in batch_iterator(train_ds, batch_size, shuffle=True, seed=seed + epoch,
                                        drop_last=True, select=own_rows):
                scale = float(ms_rng.choice(MULTISCALE_FACTORS)) if use_multiscale else 1.0
                yield host_batch(batch, scale)

    def write_last():
        if not lead:
            return
        (ckpt_dir / "last.msgpack").write_bytes(msgpack_serialize(state.weights()))
        (ckpt_dir / "last_state.msgpack").write_bytes(state.serialize())

    history = []
    for epoch in range(state.epoch, epochs):
        t_epoch = time.time()
        losses, host_s = [], [0.0]
        for image_b, score_b, geo_b in timed(train_batches(epoch), host_s):
            losses.append(train_step(state, tx, trainable, image_b, score_b, geo_b, use_sam,
                                     sam_type == "asam", use_ohem, ohem_ratio, use_focal_geo,
                                     focal_gamma, ema_decay, group))
            state.global_step += 1
        train_loss = float(np.mean(torch.stack(losses).cpu().numpy())) if losses else 0.0
        log = {"epoch": epoch, "train_loss": train_loss,
               "train_losses": [float(v) for v in torch.stack(losses).cpu()] if losses else [],
               "lr": float(schedule(state.global_step)), "time": time.time() - t_epoch,
               "host_s": host_s[0]}

        if (epoch + 1) % val_interval == 0 and val_sets:
            val_losses, val_dices = [], []
            collage_logged = False
            with torch.no_grad(), _ema_weights(model, state.ema):
                for vi, vs in enumerate(val_sets):
                    if dev_vals is not None:
                        dv = dev_vals[vi]
                        batches = ((dv.batch(np.arange(b, min(b + batch_size, len(dv)))), None)
                                   for b in range(0, len(dv), batch_size))
                    else:
                        batches = ((host_batch(b), b) for b in batch_iterator(
                            vs, batch_size, shuffle=False, drop_last=False, include_quads=True,
                            select=own_rows))
                    vl, vd = [], []
                    for (img_b, sc_b, geo_b), raw in batches:
                        loss, dice, pred_score, pred_geo = eval_step(model, img_b, sc_b, geo_b,
                                                                     group)
                        vl.append(float(loss))
                        vd.append(float(dice))
                        if writer is not None and not collage_logged:
                            collage_logged = True
                            writer.add_image("val/collage", _val_collage(
                                vs, raw, pred_score[0], pred_geo[0]), epoch, dataformats="HWC")
                    val_losses.append(float(np.mean(vl)) if vl else 0.0)
                    val_dices.append(float(np.mean(vd)) if vd else 0.0)
                    log[f"val_loss/{vs.dataset_name}"] = val_losses[-1]
                    log[f"val_dice/{vs.dataset_name}"] = val_dices[-1]
            val_loss = float(np.mean(val_losses))
            log["val_loss"] = val_loss
            log["val_dice"] = float(np.mean(val_dices))
            if val_loss < state.best_val_loss:
                state.best_val_loss = val_loss
                state.patience = 0
                if lead:
                    (ckpt_dir / "best.msgpack").write_bytes(
                        msgpack_serialize(state.weights(use_ema=use_ema)))
            else:
                state.patience += 1

        state.epoch = epoch + 1
        if ckpt_interval <= 1 or (epoch + 1) % ckpt_interval == 0 or epoch + 1 == epochs:
            write_last()
        barrier(mesh)
        if writer is not None:
            for k, v in log.items():
                if isinstance(v, (int, float)):
                    writer.add_scalar(k, v, epoch)
        history.append(log)
        if lead:
            print(f"[EAST.train] epoch {epoch}: loss={train_loss:.4f} "
                  + (f"val={log['val_loss']:.4f} " if "val_loss" in log else "")
                  + f"({log['time']:.1f}s)")
        if state.patience >= early_stop:
            write_last()  # ckpt_interval may have skipped this epoch
            if lead:
                print(f"[EAST.train] early stop at epoch {epoch}")
            break

    if writer is not None:
        writer.close()
    return {"model": model, "ema_params": state.ema, "best_val_loss": state.best_val_loss,
            "exp_dir": str(exp_dir), "history": history}
