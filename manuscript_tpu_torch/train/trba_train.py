"""TRBA training (counterpart of ``manuscript_tpu/train/trba_train.py``).

``train(train_csvs, train_roots, val_csvs, val_roots, config, device=None,
**overrides)`` keeps the JAX trainer's files and step semantics: a
JSON-or-dict ``Config`` with expN experiment folders and resume-merge; the
freeze policies (cnn / enc_rnn / attention × none / partial / full); the
token cross-entropy over non-PAD positions; Adam, AdamW or SGD with optax's
arithmetic (``optim.py``) under a global-norm clip, with the plateau scale
multiplying the final update or a cosine schedule; per-dataset validation
split or random split; proportional multi-dataset batches; per-epoch
validation with the teacher-forced loss over the *padded* batch, a greedy
decode and, with ``eval_beam``, a beam decode — both under ``torch.no_grad``
through the decoder's ``attention_step``, the hand-written kernel K1 on the
card; ``metrics_epoch.csv`` with its header migration; TensorBoard when
``torch.utils.tensorboard`` imports; and the three checkpoint families
``{last,best_loss,best_acc}.msgpack`` with ``itos`` and ``config`` embedded,
plus ``last_state.msgpack`` for resume. The weights files are flax msgpack
(``utils.weights.msgpack_serialize`` of ``params_to_jax``): the port's and
the JAX package's ``TRBA`` load them.

A step: normalize, the teacher-forced forward in train mode (dropout and
scheduled sampling draw from one ``torch.Generator`` of the device, seeded
with ``seed``), the loss, the gradients of the trainable parameters, zeroed
when the loss is not finite (the optimizer still steps: its counts advance),
the optimizer update, times the plateau scale. Nothing waits for the card
within an epoch. ``compute_dtype="bfloat16"`` runs the CNN and BiLSTMs under
``torch.autocast``; the weights, the decoder and the loss stay float32.

By design, unlike the JAX trainer: frozen parameters get no update (optax's
``masked`` passes their raw gradients through, and the JAX trainer adds them
to the weights); the optimizer state in ``last_state.msgpack`` has the
port's layout, so a JAX state file resumes weights-only, through the same
tolerant path that a changed optimizer takes; dropout draws come from torch,
not JAX's streams. ``device=None`` is the card.

Data parallelism (``n_devices`` > 1, a ``mesh``, or a process group already
initialised, e.g. by ``torchrun``): one process per data row of the mesh
(``data_parallel_mesh``); called in one process, ``train`` starts them
(``parallel.spawn``: NCCL among distinct cards, gloo on the CPU with
``device="cpu"``) and returns rank 0's result. The weights are broadcast
from rank 0 at the start and after a resume; each rank takes its slice of
each global batch (a batch that does not divide by the ranks repeats its
last row, as the JAX trainer pads); BatchNorm's statistics, the loss's
numerator and denominator and the gradients are the global batch's
(all-reduces), so every rank takes the one-device step on the global batch,
up to the order of the sums. Validation batches are padded to a multiple of
the ranks, decoded per slice and gathered. Rank 0 alone writes the log, the
CSV, TensorBoard and the checkpoints, and the ranks meet at a barrier after
each epoch. Dropout and scheduled sampling draw for the global batch from
one seed on every rank and keep the rank's rows (``models.layers.
global_draws``), so each row gets the one-device draw, as the JAX trainer
draws one mask over the global array. Each rank reads, augments and collates
only its own rows of each training batch, from datasets whose augmentation
streams are seeded from (seed, rank): the host work of a step divides among
the ranks, and the augmentations differ from a one-device run's by design
(the JAX trainer's host builds the whole batch in one process).
``history`` holds each epoch's ``host_s``, the seconds this process spent
building its training batches.
"""

from __future__ import annotations

import csv
import json
import re
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..models.layers import float32_or_wider, global_draws, sync_batch_stats
from ..models.trba import TRBAModel
from ..parallel.mesh import (
    DATA_AXIS,
    Mesh,
    all_gather_rows,
    barrier,
    broadcast_,
    initialize_distributed,
    launcher_environment,
    make_mesh,
    rank_items,
    shard_batch,
    spawn,
)
from ..recognizers.charset import (
    BLANK_TOKEN,
    EOS_TOKEN,
    PAD_TOKEN,
    SOS_TOKEN,
    decode_tokens,
    default_charset,
    load_charset,
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
from .losses import trba_ce_loss
from .metrics import aggregate_text_metrics
from .optim import (
    GradientTransformation,
    apply_updates,
    build_trba_optimizer,
    cosine_decay_schedule,
    gradients,
)
from .trba_dataset import AugmentParams, OCRDataset, collate_attention, proportional_batches

def data_parallel_mesh(n_devices: Optional[int], mesh: Optional[Mesh],
                       device: Optional[Union[str, torch.device]]) -> Optional[Mesh]:
    """The mesh a trainer runs on: ``mesh`` when given; under a process
    group, one device per rank (a launcher's group, as ``torchrun`` sets it
    up, is joined here: NCCL, or gloo with ``device="cpu"``); for
    ``n_devices`` > 1 the first ``n_devices`` cards, or with ``device="cpu"``
    as many CPU ranks; else None (one device, no mesh)."""
    if mesh is not None:
        return mesh
    if launcher_environment() and not dist.is_initialized():
        initialize_distributed(backend="gloo" if resolve_device(device).type == "cpu" else "nccl")
    if dist.is_available() and dist.is_initialized():
        return make_mesh(n_devices)
    if n_devices is None or int(n_devices) == 1:
        return None
    if resolve_device(device).type == "cpu":
        return make_mesh(devices=["cpu"] * int(n_devices))
    return make_mesh(int(n_devices))


def one_rank_per_row(mesh: Mesh) -> Mesh:
    """The mesh of ``spawn``'s ranks for a one-process ``mesh``: its data
    rows' first devices (the model axis holds replicas only)."""
    return make_mesh(devices=list(mesh.devices[:, 0]))


RANK_SEED_STRIDE = 1_000_003  # a host augmentation stream's seed: seed + stride · rank


def rank_seed(seed: int, mesh: Optional[Mesh]) -> int:
    """The seed of this process's host augmentation streams."""
    return int(seed) + RANK_SEED_STRIDE * (0 if mesh is None else mesh.rank)


def timed(batches, spent: List[float]):
    """Yield from ``batches``, adding the seconds each took to build to
    ``spent[0]``."""
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        item = next(it, None)
        spent[0] += time.perf_counter() - t0
        if item is None:
            return
        yield item


class Config:
    """JSON-or-dict config with attribute access, expN auto-naming, save()
    and resume-merge (the old experiment's config under the new overrides)."""

    DEFAULTS = dict(
        exp_root="./experiments",
        exp_name=None,
        charset_path=None,
        max_len=25,
        hidden_size=256,
        img_h=64,
        img_w=256,
        cnn_stage_plan="full",
        batch_size=64,
        epochs=100,
        lr=1e-3,
        optimizer="adam",
        weight_decay=0.0,
        grad_clip=5.0,
        scheduler="plateau",  # plateau | cosine | none
        plateau_factor=0.5,
        plateau_patience=5,
        compute_dtype="float32",
        freeze_cnn="none",
        freeze_enc_rnn="none",
        freeze_attention="none",
        pretrained_path=None,
        val_size=0.1,
        proportions=None,
        aug_params=None,
        eval_beam=False,
        beam_size=8,
        beam_alpha=0.9,
        beam_temperature=1.7,
        ss_prob=0.0,
        seed=0,
        early_stop=50,
        n_devices=None,
        resume=None,
        charset_strict=True,
    )

    def __init__(self, payload: Union[str, Dict, None] = None, **overrides):
        data = dict(self.DEFAULTS)
        if isinstance(payload, str):
            with open(payload, "r", encoding="utf-8") as f:
                data.update(json.load(f))
        elif isinstance(payload, dict):
            data.update(payload)
        data.update(overrides)
        if data.get("resume"):
            old_cfg = Path(data["resume"]) / "config.json"
            if old_cfg.exists():
                with open(old_cfg, "r", encoding="utf-8") as f:
                    old = json.load(f)
                merged = dict(self.DEFAULTS)
                merged.update(old)
                if isinstance(payload, dict):
                    merged.update(payload)
                merged.update(overrides)
                merged["resume"] = data["resume"]
                data = merged
        self._data = data
        if not data.get("exp_name"):
            data["exp_name"] = self._next_exp_name(data["exp_root"])
        self.exp_dir = Path(data["exp_root"]) / data["exp_name"]

    @staticmethod
    def _next_exp_name(root: str) -> str:
        root_p = Path(root)
        existing = []
        if root_p.exists():
            for d in root_p.iterdir():
                m = re.fullmatch(r"exp(\d+)", d.name)
                if m:
                    existing.append(int(m.group(1)))
        return f"exp{max(existing, default=0) + 1}"

    def __getattr__(self, name):
        data = object.__getattribute__(self, "_data")
        if name in data:
            return data[name]
        raise AttributeError(name)

    def to_dict(self) -> Dict:
        return dict(self._data)

    def save(self) -> None:
        self.exp_dir.mkdir(parents=True, exist_ok=True)
        with open(self.exp_dir / "config.json", "w", encoding="utf-8") as f:
            json.dump(self._data, f, ensure_ascii=False, indent=2, default=str)


def _as_list(x) -> List:
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def freeze_mask(model: TRBAModel, cfg: Config) -> Dict[str, bool]:
    """Parameter name → trainable. 'full' freezes the whole module;
    'partial' its lower half (the stem and the first two CNN stages, the
    first BiLSTM, the decoder but for its generator)."""

    def decide(name: str) -> bool:
        keys = name.split(".")
        top = keys[0]
        if top == "cnn":
            if cfg.freeze_cnn == "full":
                return False
            if cfg.freeze_cnn == "partial":
                return not any(keys[1].startswith(e) for e in ("stem_", "layer1_", "layer2_"))
            return True
        if top in ("enc_rnn1", "enc_rnn2"):
            if cfg.freeze_enc_rnn == "full":
                return False
            if cfg.freeze_enc_rnn == "partial":
                return top == "enc_rnn2"
            return True
        if top == "decoder":
            if cfg.freeze_attention == "full":
                return False
            if cfg.freeze_attention == "partial":
                return keys[1].startswith("gen_")
            return True
        return True

    return {name: decide(name) for name, _ in model.named_parameters()}


def normalize(image_u8: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 pixels → (x / 255 − 0.5) / 0.5."""
    return (image_u8.to(dtype) / 255.0 - 0.5) / 0.5


def autocast_for(device: torch.device, compute_dtype: str):
    """``torch.autocast`` to bfloat16 when ``compute_dtype`` asks for it."""
    if compute_dtype == "bfloat16":
        return torch.autocast(device.type, dtype=torch.bfloat16)
    if compute_dtype != "float32":
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {compute_dtype!r}")
    return nullcontext()


def guard_finite(loss: torch.Tensor, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zero every gradient when the loss is not finite (on the device)."""
    finite = torch.isfinite(loss)
    return {k: torch.where(finite, g, torch.zeros_like(g)) for k, g in grads.items()}


def train_step(
    model: TRBAModel,
    tx: GradientTransformation,
    opt_state: Dict,
    params: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    pad_id: int,
    ss_prob: float = 0.0,
    lr_scale: float = 1.0,
    generator: Optional[torch.Generator] = None,
    compute_dtype: str = "float32",
    group=None,
) -> Tuple[torch.Tensor, Dict]:
    """One optimizer step on ``params`` (the trainable parameters, updated in
    place) → (loss, new optimizer state). ``batch`` holds "image" (B, H, W,
    3) uint8, "text_in" and "target_y" (B, T) int on the model's device.
    With a process ``group`` the batch is this rank's slice (the ranks'
    slices equal in size) and the loss and gradients are the global batch's
    (the model's BatchNorms synchronised by ``models.layers.
    sync_batch_stats``); dropout and scheduled sampling draw for the global
    batch (``global_draws``). Its three parts are the profiler regions
    ``trba.forward``, ``trba.backward`` and ``trba.optimizer``."""
    model.train()
    draws = (nullcontext() if group is None
             else global_draws(dist.get_rank(group), dist.get_world_size(group)))
    with annotate("trba.forward"), draws:
        x = normalize(batch["image"], next(model.parameters()).dtype)
        with autocast_for(x.device, compute_dtype):
            logits = model(x, batch["text_in"], ss_prob=ss_prob, generator=generator)
        loss = trba_ce_loss(float32_or_wider(logits), batch["target_y"], pad_id, group)
    with annotate("trba.backward"):
        grads = guard_finite(loss, dict(zip(params, gradients(loss, list(params.values()), group))))
    with annotate("trba.optimizer"):
        updates, opt_state = tx.update(grads, opt_state, params)
        apply_updates(params, updates, None if lr_scale == 1.0 else lr_scale)
    return loss.detach(), opt_state


def _gathered(preds: torch.Tensor, mesh: Optional[Mesh]) -> np.ndarray:
    """Token ids of every rank's slice, in row order, on the host."""
    return (preds if mesh is None else all_gather_rows(preds, mesh)).cpu().numpy()


def _pad_batch(batch: Dict[str, Any], to: int) -> Tuple[Dict, int]:
    """Repeat the last row up to ``to`` rows (arrays only)."""
    n = batch["image"].shape[0]
    if n == to:
        return batch, n
    return {k: np.concatenate([v, np.repeat(v[-1:], to - n, axis=0)])
            for k, v in batch.items() if isinstance(v, np.ndarray)}, n


class _SubsetDataset:
    """An OCRDataset restricted to some indices, optionally with its
    augmentation switched on or off."""

    def __init__(self, base: OCRDataset, indices, augment: Optional[bool] = None):
        self.base = base
        self.indices = np.asarray(indices)
        self._augment = augment
        self.name = getattr(base, "name", "ds") + ("_val" if augment is False else "")

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        if self._augment is None:
            return self.base[int(self.indices[idx])]
        saved = self.base.augment
        self.base.augment = self._augment
        try:
            return self.base[int(self.indices[idx])]
        finally:
            self.base.augment = saved


CSV_FIELDS = ["epoch", "train_loss", "val_loss", "val_acc", "val_cer", "val_wer",
              "val_beam_acc", "val_beam_cer", "val_beam_wer", "lr_scale", "time_s"]


def prepare_metrics_csv(path: Path, log) -> None:
    """Write the header, or migrate an older file's rows under the current
    header (missing columns empty)."""
    if not path.exists():
        with open(path, "w", newline="", encoding="utf-8") as f:
            csv.writer(f).writerow(CSV_FIELDS)
        return
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    if rows and rows[0] != CSV_FIELDS:
        old_header, old_rows = rows[0], rows[1:]
        idx = {name: i for i, name in enumerate(old_header)}
        migrated = [[(r[idx[n]] if n in idx and idx[n] < len(r) else "") for n in CSV_FIELDS]
                    for r in old_rows]
        with open(path, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(CSV_FIELDS)
            w.writerows(migrated)
        log(f"migrated {path.name} from {len(old_header)}-column to {len(CSV_FIELDS)}-column layout")


def _to_device(batch: Dict[str, np.ndarray], device: torch.device,
               mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """The step's tensors on ``device``; with a mesh, this rank's slice."""
    arrays = {k: np.ascontiguousarray(batch[k]) for k in ("image", "text_in", "target_y")}
    if mesh is not None:
        return shard_batch(arrays, mesh)[0]
    return {k: torch.from_numpy(v).to(device, non_blocking=True) for k, v in arrays.items()}


def _rank_main(mesh: Mesh, train_csvs, train_roots, val_csvs, val_roots, config: Dict):
    out = train(train_csvs, train_roots, val_csvs, val_roots, config=config, mesh=mesh)
    sync_batch_stats(out["model"], None)  # the group ends with this process
    out["model"] = out["model"].cpu()
    return out


def train(
    train_csvs: Union[str, Sequence[str]] = None,
    train_roots: Union[str, Sequence[str]] = None,
    val_csvs: Optional[Union[str, Sequence[str]]] = None,
    val_roots: Optional[Union[str, Sequence[str]]] = None,
    config: Union[str, Dict, Config, None] = None,
    device: Optional[Union[str, torch.device]] = None,
    mesh: Optional[Mesh] = None,
    **overrides,
) -> Dict[str, Any]:
    """High-level TRBA training → {"val_acc", "val_loss", "exp_dir", "model",
    "history"}. ``device=None`` is the card; ``cfg.n_devices`` or ``mesh``
    train data-parallel (module docstring)."""
    cfg = config if isinstance(config, Config) else Config(config, **overrides)
    mesh = data_parallel_mesh(cfg.n_devices, mesh, device)
    if mesh is not None and mesh.group is None and mesh.shape[DATA_AXIS] > 1:
        out = spawn(_rank_main, one_rank_per_row(mesh), train_csvs, train_roots, val_csvs,
                    val_roots, cfg.to_dict())
        out["model"] = out["model"].to(mesh.devices[0, 0])
        return out
    group = None if mesh is None else mesh.group
    lead = mesh is None or mesh.rank == 0  # writes the files
    dev = resolve_device(device) if mesh is None else mesh.local_shards[0][1]
    n_data = 1 if mesh is None else mesh.shape[DATA_AXIS]
    if lead:
        cfg.save()
    rng_np = np.random.default_rng(cfg.seed)
    log_path = cfg.exp_dir / "train.log"

    def log(msg: str):
        if not lead:
            return
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        print(line)
        with open(log_path, "a", encoding="utf-8") as f:
            f.write(line + "\n")

    # ---- charset ----
    if cfg.charset_path:
        itos, stoi = load_charset(cfg.charset_path)
    else:
        itos = default_charset()
        stoi = {s: i for i, s in enumerate(itos)}
    pad_id, sos_id, eos_id = stoi[PAD_TOKEN], stoi[SOS_TOKEN], stoi[EOS_TOKEN]
    blank_id = stoi.get(BLANK_TOKEN)

    # ---- datasets ----
    aug = AugmentParams.from_config(cfg.aug_params or {})
    train_sets, val_sets = [], []
    v_csvs, v_roots = _as_list(val_csvs), _as_list(val_roots)
    for i, (csv_path, root) in enumerate(zip(_as_list(train_csvs), _as_list(train_roots))):
        ds = OCRDataset(csv_path, root, stoi, max_len=cfg.max_len, img_h=cfg.img_h,
                        img_w=cfg.img_w, augment=True, augment_params=aug,
                        charset_strict=cfg.charset_strict, seed=rank_seed(cfg.seed, mesh) + i)
        if i < len(v_csvs):
            train_sets.append(ds)
            val_sets.append(OCRDataset(v_csvs[i], v_roots[i], stoi, max_len=cfg.max_len,
                                       img_h=cfg.img_h, img_w=cfg.img_w, augment=False,
                                       charset_strict=cfg.charset_strict))
        else:  # a random split of val_size off the training set
            n_val = max(1, int(len(ds) * cfg.val_size))
            idx = rng_np.permutation(len(ds))
            val_sets.append(_SubsetDataset(ds, idx[:n_val], augment=False))
            train_sets.append(_SubsetDataset(ds, idx[n_val:]))
    if not train_sets:
        raise ValueError("No training datasets provided")

    # ---- model ----
    model = TRBAModel(len(itos), cfg.hidden_size, sos_id, eos_id, blank_id, cfg.cnn_stage_plan)
    init_random_(model, cfg.seed)
    if cfg.pretrained_path:
        try:
            if str(cfg.pretrained_path).endswith(".pth"):  # the reference's layout
                from ..utils.convert import convert_trba, load_torch_state_dict, merge_converted

                state = load_torch_state_dict(cfg.pretrained_path)
                model.load_state_dict(merge_converted(model.state_dict(), convert_trba(state)))
            else:
                model.load_state_dict(params_from_jax(msgpack_restore(Path(cfg.pretrained_path))))
            log(f"loaded pretrained weights from {cfg.pretrained_path}")
        except Exception as e:  # tolerant load: warn and keep the random init
            log(f"pretrained load failed ({e}); continuing with random init")
    model.to(dev)
    sync_batch_stats(model, group)

    # ---- optimizer ----
    steps_per_epoch = max(1, sum(len(d) for d in train_sets) // cfg.batch_size)
    schedule = (cosine_decay_schedule(cfg.lr, cfg.epochs * steps_per_epoch, alpha=0.01)
                if cfg.scheduler == "cosine" else None)
    tx = build_trba_optimizer(cfg.optimizer, cfg.lr, cfg.weight_decay, cfg.grad_clip, schedule)
    mask = freeze_mask(model, cfg)
    params = {}
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params[name] = p
    if not all(mask.values()):
        log(f"freeze policies active: cnn={cfg.freeze_cnn} enc_rnn={cfg.freeze_enc_rnn} "
            f"attention={cfg.freeze_attention}")
    opt_state = tx.init(params)

    # ---- resume ----
    start_epoch = 0
    best_val_loss, best_val_acc, patience = float("inf"), -1.0, 0
    ckpt_dir = cfg.exp_dir / "checkpoints"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if cfg.resume:
        state_file = Path(cfg.resume) / "checkpoints" / "last_state.msgpack"
        if state_file.exists():
            restored = msgpack_restore(state_file)
            model.load_state_dict(params_from_jax(restored))
            try:
                opt_state = restore_tree(opt_state, restored["opt_state"])
            except (ValueError, KeyError, TypeError) as e:
                log(f"optimizer state restore failed ({e}); weights-only resume")
            meta = restored["meta"]
            start_epoch = int(meta["epoch"])
            best_val_loss = float(meta["best_val_loss"])
            best_val_acc = float(meta["best_val_acc"])
            patience = int(meta["patience"])
            log(f"resumed from {state_file} at epoch {start_epoch}")
    if mesh is not None:  # every rank starts from rank 0's weights
        broadcast_(list(model.state_dict().values()), mesh)

    writer = None
    if lead:
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(log_dir=str(cfg.exp_dir / "tb"))
        except Exception:
            pass

    metrics_csv = cfg.exp_dir / "metrics_epoch.csv"
    if lead:
        prepare_metrics_csv(metrics_csv, log)
    proportions = cfg.proportions or [1.0 / len(train_sets)] * len(train_sets)
    generator = torch.Generator(device=dev).manual_seed(int(cfg.seed))
    # validation pads each batch to batch_size rows, and that to the ranks
    val_rows = -(-cfg.batch_size // n_data) * n_data
    plateau = {"scale": 1.0, "patience": 0}
    decode = lambda p: decode_tokens(p, itos, pad_id, eos_id, blank_id)

    def save_ckpt(name: str, full_state: bool, epoch: int):
        if not lead:
            return
        weights = params_to_jax(model.state_dict())
        weights["itos"] = list(itos)
        weights["config"] = {k: v for k, v in cfg.to_dict().items()
                             if isinstance(v, (int, float, str, bool, type(None)))}
        (ckpt_dir / f"{name}.msgpack").write_bytes(msgpack_serialize(weights))
        if full_state:
            state = params_to_jax(model.state_dict())
            state["opt_state"] = opt_state
            state["meta"] = {"epoch": epoch + 1, "best_val_loss": best_val_loss,
                             "best_val_acc": best_val_acc, "patience": patience}
            (ckpt_dir / f"{name}_state.msgpack").write_bytes(msgpack_serialize(state))

    def train_batches(epoch: int):
        """The epoch's training batches on the device: with a mesh, this
        rank's rows of each batch padded to the ranks (its last row
        repeated, as the JAX trainer pads), the only ones it loads."""
        for batch_spec in proportional_batches(train_sets, proportions, cfg.batch_size,
                                               seed=cfg.seed + epoch):
            if mesh is not None:
                batch_spec = rank_items(batch_spec, mesh, repeat_last=True)
            batch = collate_attention([train_sets[d][i] for d, i in batch_spec], stoi, cfg.max_len)
            yield _to_device(batch, dev)

    history = []
    final_val_acc, final_val_loss = 0.0, float("inf")
    for epoch in range(start_epoch, cfg.epochs):
        t_epoch = time.time()
        losses, host_s = [], [0.0]
        for batch in timed(train_batches(epoch), host_s):
            loss, opt_state = train_step(
                model, tx, opt_state, params, batch, pad_id, cfg.ss_prob,
                plateau["scale"], generator, cfg.compute_dtype, group,
            )
            losses.append(loss)
        train_loss = float(np.mean(torch.stack(losses).cpu().numpy())) if losses else 0.0

        # ---- validation: padded-batch loss, greedy (and beam) decodes ----
        model.eval()
        all_refs, all_hyps, all_beam_hyps, vlosses, per_set = [], [], [], [], {}
        with torch.no_grad(), autocast_for(dev, cfg.compute_dtype):
            for vs in val_sets:
                refs, hyps, beam_hyps, vl = [], [], [], []
                for start in range(0, len(vs), cfg.batch_size):
                    items = [vs[i] for i in range(start, min(start + cfg.batch_size, len(vs)))]
                    batch = collate_attention(items, stoi, cfg.max_len)
                    padded, n = _pad_batch(batch, val_rows)
                    t = _to_device(padded, dev, mesh)
                    x = normalize(t["image"])
                    vl.append(trba_ce_loss(model(x, t["text_in"]).float(), t["target_y"], pad_id,
                                           group))
                    # one device decodes the batch's own rows; ranks their
                    # slices of the padded batch, gathered
                    x = x if mesh is not None else x[:n]
                    _, preds = model.greedy(x, cfg.max_len)
                    hyps.extend(decode(p) for p in _gathered(preds, mesh)[:n])
                    if cfg.eval_beam:
                        _, bpreds = model.beam(x, cfg.max_len, cfg.beam_size,
                                               cfg.beam_alpha, cfg.beam_temperature)
                        beam_hyps.extend(decode(p) for p in _gathered(bpreds, mesh)[:n])
                    refs.extend(batch["texts"][:n])
                m = aggregate_text_metrics(refs, hyps)
                m["loss"] = float(np.mean([float(v) for v in vl])) if vl else 0.0
                if cfg.eval_beam:
                    bm = aggregate_text_metrics(refs, beam_hyps)
                    m.update(beam_accuracy=bm["accuracy"], beam_cer=bm["cer"], beam_wer=bm["wer"])
                per_set[getattr(vs, "name", "val")] = m
                all_refs.extend(refs)
                all_hyps.extend(hyps)
                all_beam_hyps.extend(beam_hyps)
                vlosses.append(m["loss"])
        agg = aggregate_text_metrics(all_refs, all_hyps)
        beam_agg = aggregate_text_metrics(all_refs, all_beam_hyps) if cfg.eval_beam else None
        val_loss = float(np.mean(vlosses)) if vlosses else float("inf")
        val_acc = agg["accuracy"]
        final_val_acc, final_val_loss = val_acc, val_loss

        if cfg.scheduler == "plateau":
            if val_loss < best_val_loss - 1e-6:
                plateau["patience"] = 0
            else:
                plateau["patience"] += 1
                if plateau["patience"] >= cfg.plateau_patience:
                    plateau["scale"] *= cfg.plateau_factor
                    plateau["patience"] = 0
                    log(f"plateau: lr scale → {plateau['scale']:.4f}")

        if val_loss < best_val_loss:
            best_val_loss = val_loss
            patience = 0
            save_ckpt("best_loss", full_state=False, epoch=epoch)
        else:
            patience += 1
        if val_acc > best_val_acc:
            best_val_acc = val_acc
            save_ckpt("best_acc", full_state=False, epoch=epoch)
        save_ckpt("last", full_state=True, epoch=epoch)

        dt = time.time() - t_epoch
        history.append({"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss,
                        "val_acc": val_acc, "val_cer": agg["cer"],
                        "train_losses": [float(v) for v in torch.stack(losses).cpu()] if losses else [],
                        "beam": beam_agg, "time_s": dt, "host_s": host_s[0]})
        barrier(mesh)
        if not lead:
            if patience >= cfg.early_stop:
                break
            continue
        log(f"epoch {epoch}: train={train_loss:.4f} val={val_loss:.4f} acc={val_acc:.4f} "
            f"cer={agg['cer']:.4f} wer={agg['wer']:.4f} "
            + (f"beam_acc={beam_agg['accuracy']:.4f} " if beam_agg is not None else "")
            + f"({dt:.1f}s)")
        beam_cols = ([beam_agg["accuracy"], beam_agg["cer"], beam_agg["wer"]]
                     if beam_agg is not None else ["", "", ""])
        with open(metrics_csv, "a", newline="", encoding="utf-8") as f:
            csv.writer(f).writerow([epoch, train_loss, val_loss, val_acc, agg["cer"], agg["wer"],
                                    *beam_cols, plateau["scale"], round(dt, 2)])
        if writer is not None:
            writer.add_scalar("train/loss", train_loss, epoch)
            writer.add_scalar("val/loss", val_loss, epoch)
            writer.add_scalar("val/acc", val_acc, epoch)
            writer.add_scalar("val/cer", agg["cer"], epoch)
            if beam_agg is not None:
                writer.add_scalar("val/beam_acc", beam_agg["accuracy"], epoch)
                writer.add_scalar("val/beam_cer", beam_agg["cer"], epoch)
            for name, m in per_set.items():
                writer.add_scalar(f"val/{name}/acc", m["accuracy"], epoch)
        if patience >= cfg.early_stop:
            log(f"early stop at epoch {epoch}")
            break

    if writer is not None:
        writer.close()
    return {"val_acc": final_val_acc, "val_loss": final_val_loss, "exp_dir": str(cfg.exp_dir),
            "model": model, "history": history}
