"""Driver ``east_train``: the EAST trainer's step, ``east_train.train_step``,
on an ``EASTTrainState`` built as ``east_train.train`` builds it.

The traffic's parameters: ``pages`` (synthetic pages made on the card from
the seed, at the configuration's ``target_size``, with their score and
geometry maps: rows of word boxes on paper), ``line_height``, ``word_width``
and ``gap`` (ranges in pixels), ``check_steps`` (the first steps, which the
reference follows), ``trace_calls``. Batches are gathered on the card from
the pages in a seeded order per epoch and resized to the step's side, as the
trainer's ``cache_device`` path does it, without its colour jitter. The
sides are the recipe's multiscale factors, each drawn once in every cycle of
as many steps, in a seeded order, so that every seed does the same work; the
set-up runs the first cycle, which warms every side.

The check: the reference (``reference/east.py``, float32, TF32 off) follows
the first ``check_steps`` steps (the set-up's, one at each side of the
first cycle) from the same weights and batches, and replays a late step
of the window from the program's state before it: its weights and momentum
trace, which the timed calls copy aside before window steps 0, 1, 3, 7,
15, … (the last of them past the window's middle, and few enough that the
copies cost the window nothing to speak of). Compared, under
the configuration's ``limits``:

* ``loss_gap``: the widest relative gap of a checked step's loss;
* ``grad_gap.backbone``, ``grad_gap.head``: the first gradient as the
  optimizer gets it (the program's: SGD's momentum trace after one step),
  as the largest over the part's groups of the group's median leaf gap
  between the norms of the program's and the reference's leaves, over the
  larger of the reference leaf's norm and the median leaf's; the groups are
  the backbone's stages in one part, the decoder and the heads in the other;
* ``delta_gap.backbone``, ``delta_gap.head``: the same of the parameters'
  change over the checked steps;
* ``frozen_moved``: the largest change of a frozen parameter by the
  replayed step (exact: 0);
* ``late_grad_gap``: as ``grad_gap``, over every group, of that step's
  gradient (the program's: its momentum trace after the step less the
  momentum times the trace before it).

Leaves whose first gradient in the reference is under a thousandth of the
median leaf's (biases that a BatchNorm follows) are left out. A group's
median leaf, not the widest leaf: the widest is a BatchNorm scale or shift whose
gradient is a sum that all but cancels, where float32 itself parts from
float64 by a good share (PERF.md); the widest three of each are printed
as notes. The variant ``witness_f64`` (``calibrate.py``) also runs the
reference in float64 and notes how far each side lies from it.
"""

from __future__ import annotations

import gc
import statistics
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import counts
from perfbench.harness import Check
from perfbench.precision import plain_float32
from perfbench.reference import east as ref
from perfbench.weights import layout_of, make_weights

FROZEN = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1_")


def snap32(x: float) -> int:
    return max(32, int(round(x / 32)) * 32)


def make_pages(n: int, side: int, scale: float, traffic: Dict, seed: int, device):
    """(images u8 (n, side, side, 3), score (n, s, s), geometry (n, s, s, 8))
    with s = side·scale: words as boxes of ink on paper; the score map is 1
    inside each box shrunk by 0.3 of its height, and the geometry holds the
    shrunk box's corners TL, TR, BR, BL as offsets (x − col, y − row) in map
    pixels."""
    rng = np.random.default_rng([seed, 11])
    g = torch.Generator(device=device).manual_seed(seed)
    s = int(side * scale)
    images = torch.empty(n, side, side, 3, dtype=torch.uint8, device=device)
    score = torch.zeros(n, s, s, device=device)
    geo = torch.zeros(n, s, s, 8, device=device)
    lh, ww, gap = traffic["line_height"], traffic["word_width"], traffic["gap"]
    pix = torch.arange(side, device=device, dtype=torch.float32)
    mpix = torch.arange(s, device=device, dtype=torch.float32)
    for p in range(n):
        boxes, y = [], float(rng.integers(*gap))
        while True:
            h = float(rng.integers(*lh))
            if y + h > side - gap[0]:
                break
            x = float(rng.integers(*gap))
            while True:
                w = float(rng.integers(*ww))
                if x + w > side - gap[0]:
                    break
                boxes.append((x, y, x + w, y + h))
                x += w + float(rng.integers(*gap))
            y += h + float(rng.integers(*gap))
        b = torch.tensor(boxes, device=device)
        inside = ((pix[None] >= b[:, 1:2]) & (pix[None] < b[:, 3:4]))[:, :, None] & \
                 ((pix[None] >= b[:, 0:1]) & (pix[None] < b[:, 2:3]))[:, None, :]
        words = inside.any(0)
        low = torch.randn(1, 1, side // 8, side // 4, generator=g, device=device)
        field = F.interpolate(low, size=(side, side), mode="bilinear", align_corners=False)[0, 0]
        ink = torch.sigmoid(6.0 * (field - 0.3)) * words
        u = torch.rand(4, generator=g, device=device)
        paper = 222.0 + 24.0 * u[0] + 4.0 * torch.randn(side, side, generator=g, device=device)
        gray = paper - ink * (120.0 + 80.0 * u[1])
        tint = torch.stack([torch.zeros_like(u[2]), 6.0 * (u[2] - 0.5), 8.0 * (u[3] - 0.5)])
        images[p] = (gray[..., None] + tint).round().clamp(0, 255).to(torch.uint8)
        d = 0.3 * torch.minimum(b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]) / 2 ** 0.5
        sb = torch.stack([b[:, 0] + d, b[:, 1] + d, b[:, 2] - d, b[:, 3] - d], 1) * scale
        hit = ((mpix[None] >= sb[:, 1:2]) & (mpix[None] < sb[:, 3:4]))[:, :, None] & \
              ((mpix[None] >= sb[:, 0:1]) & (mpix[None] < sb[:, 2:3]))[:, None, :]
        covered = hit.any(0)
        box = sb[hit.float().argmax(0)]  # (s, s, 4): x0, y0, x1, y1
        cols, rows = mpix[None, :].expand(s, s), mpix[:, None].expand(s, s)
        corners = [(box[..., 0], box[..., 1]), (box[..., 2], box[..., 1]),
                   (box[..., 2], box[..., 3]), (box[..., 0], box[..., 3])]
        g8 = torch.stack([v for vx, vy in corners for v in (vx - cols, vy - rows)], -1)
        score[p] = covered.float()
        geo[p] = g8 * covered[..., None]
    return images, score, geo


class Session:
    unit = "samples"
    failed = 0  # a step that fails raises

    def __init__(self, cell):
        cfg, tr = cell.config, cell.traffic
        self.cell, self.cfg, self.tr = cell, cfg, tr
        dev = cell.device
        self.bs = int(cfg["batch_size"])
        self.base = int(cfg["target_size"])
        self.images, self.score, self.geo = make_pages(int(tr["pages"]), self.base, cfg["score_geo_scale"],
                                                       tr, cell.seed, dev)
        self.spe = len(self.images) // self.bs
        self.factors = list(cfg["multiscale_factors"]) if cfg["use_multiscale"] else [1.0]
        self.weights = make_weights(ref.layout(cfg), cell.seed, dev)
        self.params = [k for k in self.weights if not k.endswith(("running_mean", "running_var"))]
        self.trainable = [k for k in self.params if not (cfg["freeze_first"] and k.startswith(FROZEN))]
        self.sides: List[int] = []
        self.i = 0
        n_check = int(tr["check_steps"])
        self.snap = None  # (weights, momentum trace) before the kept step, its trace after
        self.kept = None  # the kept step
        if cell.variant == "reference_bf16":  # the control: the reference in bfloat16 in the program's place
            self.state = None
            trainer = ref.Trainer(cfg, self.weights, self.trainable, self.spe)
            with torch.autocast(dev.type, dtype=torch.bfloat16):
                for step in range(n_check):
                    trainer.step(*self.batch(step))
            self.readings = (trainer.losses, trainer.first_gradient, trainer.parameters())
            return
        self.state, self.tx, self.opt_params = self._build(torch.float32)
        losses, first = [], None
        for step in range(max(n_check, len(self.factors))):
            losses.append(self._step())
            if step == 0:
                first = {k: t.detach().clone() for k, t in self.opt_trace().items()}
            if step == n_check - 1:
                after = {k: p.detach().clone() for k, p in self.state.model.named_parameters()}
        self.readings = ([float(x) for x in losses[:n_check]], first, after)
        self.params_live = dict(self.state.model.named_parameters())  # updated in place
        trace = self.opt_trace()
        self.snap = ({k: torch.empty_like(p) for k, p in self.params_live.items()},
                     {k: torch.empty_like(t) for k, t in trace.items()},
                     {k: torch.empty_like(t) for k, t in trace.items()})
        self._copy(self.snap[0], self.params_live)
        self._copy(self.snap[1], trace)
        self._copy(self.snap[2], trace)
        self.win0 = self.i  # the window's first step
        self.finish()
        self.sides.clear()

    @staticmethod
    def _copy(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]) -> None:
        with torch.no_grad():
            torch._foreach_copy_(list(dst.values()), [src[k] for k in dst])

    def _build(self, dtype):
        """(train state, optimizer, trainable parameters) as ``train`` builds
        them, from the seed's weights, in ``dtype``."""
        from manuscript_tpu_torch.models.east import EASTModel
        from manuscript_tpu_torch.train import east_train as et
        from manuscript_tpu_torch.train.optim import build_east_optimizer

        cfg = self.cfg
        with torch.device(self.cell.device):
            model = EASTModel(cfg["backbone"])
        if layout_of(model) != ref.layout(cfg):
            raise ValueError("perfbench: the detector's weights do not have the configuration's layout")
        model.load_state_dict(self.weights)
        model.to(dtype)
        tx, _ = build_east_optimizer(cfg["lr"], self.spe, use_sam=cfg["use_sam"],
                                     use_lookahead=cfg["use_lookahead"], grad_clip=cfg["grad_clip"],
                                     t_0=cfg["t_0"])
        mask = et.freeze_mask(model, cfg["freeze_first"])
        trainable = {}
        for name, p in model.named_parameters():
            p.requires_grad_(cfg["use_sam"] or mask[name])
            if mask[name]:
                trainable[name] = p
        return et.EASTTrainState(model, tx.init(trainable), None), tx, trainable

    def opt_trace(self, state=None) -> Dict[str, torch.Tensor]:
        """SGD's momentum trace: clip → (trace → learning rate)."""
        return (state or self.state).opt_state["1"]["0"]["trace"]

    def side(self, step: int) -> int:
        cycle, j = divmod(step, len(self.factors))
        order = np.random.default_rng([self.cell.seed, 101, cycle]).permutation(len(self.factors))
        return snap32(self.base * self.factors[order[j]])

    def batch(self, step: int):
        """(image u8 (B, side, side, 3), score, geometry) of step ``step``."""
        epoch, b = divmod(step, self.spe)
        perm = np.random.default_rng([self.cell.seed, 23, epoch]).permutation(len(self.images))
        idx = torch.as_tensor(perm[b * self.bs:(b + 1) * self.bs], device=self.cell.device)
        im = self.images[idx].float()
        side = self.side(step)
        if side != self.base:
            im = F.interpolate(im.permute(0, 3, 1, 2), size=(side, side), mode="bilinear",
                               align_corners=False, antialias=True).permute(0, 2, 3, 1)
        return im.clamp(0.0, 255.0).to(torch.uint8), self.score[idx], self.geo[idx]

    def _step(self):
        image, score, geo = self.batch(self.i)
        self.sides.append(self.side(self.i))
        loss = self._train_step(self.state, self.tx, self.opt_params, image, score, geo)
        self.state.global_step += 1
        self.i += 1
        return loss

    def _train_step(self, state, tx, trainable, image, score, geo):
        from manuscript_tpu_torch.train import east_train as et

        cfg = self.cfg
        return et.train_step(state, tx, trainable, image, score, geo, cfg["use_sam"],
                             cfg["sam_type"] == "asam", cfg["use_ohem"], cfg["ohem_ratio"],
                             cfg["use_focal_geo"], cfg["focal_gamma"], 0.999, None)

    def call(self) -> int:
        if self.kept == self.i - 1:  # the trace after the kept step
            self._copy(self.snap[2], self.opt_trace())
        n = self.i - self.win0
        keep = (n & (n + 1)) == 0  # window steps 0, 1, 3, 7, ...
        if keep:
            self._copy(self.snap[0], self.params_live)
            self._copy(self.snap[1], self.opt_trace())
        loss = self._step()
        if keep:
            self.kept, self.kept_loss = self.i - 1, loss
        return self.bs

    def finish(self) -> None:
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)

    def counts(self) -> Dict:
        return {"traced_flops": sum(counts.east_train_step_flops(s, self.bs, self.cfg["backbone"])
                                    for s in self.sides)}

    def free(self) -> None:
        if self.state is not None and self.kept == self.i - 1:  # the window ended with the kept step
            self._copy(self.snap[2], self.opt_trace())
        self.state = self.tx = self.opt_params = None
        gc.collect()
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Check:
        cfg, limits = self.cfg, self.cfg["limits"]
        losses, first, after = self.readings
        n_check = int(self.tr["check_steps"])
        with plain_float32():
            trainer = ref.Trainer(cfg, self.weights, self.trainable, self.spe)
            for step in range(n_check):
                trainer.step(*self.batch(step))
        chk = Check()
        chk.add("loss_gap", loss_gap(losses, trainer.losses, n_check), limits["loss_gap"])
        norms = {k: float(t.double().norm()) for k, t in trainer.first_gradient_all.items()}
        floor = 1e-3 * statistics.median(norms.values())
        counted = [k for k in self.trainable if norms[k] >= floor]
        for name, got, want in (("grad_gap", first, trainer.first_gradient),
                                ("delta_gap", {k: after[k].double() - self.weights[k].double() for k in counted},
                                 {k: trainer.params[k].detach().double() - self.weights[k].double()
                                  for k in counted})):
            med = group_gaps(got, want, counted, chk.notes, name)
            for part in PARTS:
                chk.add(f"{name}.{part}", worst(med, part), limits[f"{name}.{part}"])
        chk.notes.append(f"median first gradient {statistics.median(norms.values())!r}, "
                         f"{len(norms) - len(counted) - (len(self.params) - len(self.trainable))} "
                         "trainable leaves under a thousandth of it")
        if self.cell.variant == "witness_f64":
            self._witness(first, trainer, counted, chk.notes)
        if self.snap is None:  # a control that runs no window
            return chk
        del trainer
        before, trace_before, trace_after = self.snap
        frozen = [k for k in self.params if k not in self.trainable]
        chk.add("frozen_moved", max((float((before[k] - self.weights[k]).abs().max()) for k in frozen),
                                    default=0.0), limits["frozen_moved"])
        last = self.kept
        with plain_float32():
            late = ref.Trainer(cfg, before, self.trainable, self.spe, trace_before, last)
            late.step(*self.batch(last))
        chk.notes.append(f"late loss gap {loss_gap([float(self.kept_loss)], late.losses, 1)!r} "
                         "(not compared: no fault reads ten times it)")
        mu = cfg["momentum"]
        g_prog = {k: trace_after[k].double() - mu * trace_before[k].double() for k in trace_before}
        med = group_gaps(g_prog, late.gradient, counted, chk.notes, f"late_grad_gap, step {last}")
        chk.add("late_grad_gap", worst(med, ""), limits["late_grad_gap"])
        return chk

    def _witness(self, first, trainer, counted, notes: List[str]) -> None:
        """The first gradient of the reference in float64: how far the
        program, the float32 reference and the program in float64 each lie
        from it."""
        w64 = {k: t.double() for k, t in self.weights.items()}
        t64 = ref.Trainer(self.cfg, w64, self.trainable, self.spe)
        t64.step(*self.batch(0))
        want = t64.first_gradient
        del t64
        state, tx, trainable = self._build(torch.float64)
        self._train_step(state, tx, trainable, *self.batch(0))
        first64 = {k: t.detach().clone() for k, t in self.opt_trace(state).items()}
        del state, tx, trainable
        for label, got in (("program", first), ("reference_f32", trainer.first_gradient),
                           ("program_f64", first64)):
            group_gaps(got, want, counted, notes, f"witness {label} vs reference_f64")


def loss_gap(prog: List[float], want: List[float], n: int) -> float:
    """The widest relative gap of ``n`` losses; inf if one is missing or not finite."""
    gaps = [abs(a - b) / abs(b) if np.isfinite(a) else float("inf") for a, b in zip(prog, want)]
    return max(gaps) if len(gaps) == n else float("inf")


# the parts whose groups share a limit: the backbone's stages, whose
# BatchNorm leaves round far in float32, and the decoder with the heads
PARTS = ("backbone", "head")


def group_part(group: str) -> str:
    return "backbone" if group.startswith("backbone.") else "head"


def group_of(name: str) -> str:
    """A leaf's group: the backbone's stage, the decoder, or the heads."""
    top, rest = name.split(".", 1)
    if top == "backbone":
        return "backbone." + rest.split("_", 1)[0].split(".", 1)[0]
    return top if top == "decoder" else "heads"


def group_gaps(prog: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], keys, notes: List[str],
               label: str) -> Dict[str, float]:
    """{group: the median over its ``keys`` of ``leaf_gaps``}; each group's
    median and the three widest leaves go into ``notes``."""
    gap = leaf_gaps(prog, want, keys)
    groups: Dict[str, List[float]] = {}
    for k, v in gap.items():
        groups.setdefault(group_of(k), []).append(v)
    medians = {g: statistics.median(v) for g, v in groups.items()}
    notes.append(f"{label}: group medians " + ", ".join(f"{g} {m:.3e}" for g, m in sorted(medians.items()))
                 + "; widest " + ", ".join(f"{k} {gap[k]:.3e}"
                                           for k in sorted(gap, key=gap.get, reverse=True)[:3]))
    return medians


def worst(medians: Dict[str, float], part: str) -> float:
    """The largest median of the groups in ``part`` (every group for "");
    inf if there is none or it is not finite."""
    vals = [m for g, m in medians.items() if not part or group_part(g) == part]
    top = max(vals, default=float("inf"))
    return top if np.isfinite(top) else float("inf")


def leaf_gaps(prog: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], keys) -> Dict[str, float]:
    """{leaf: | ‖prog‖ − ‖want‖ | / max(‖want‖, the median of the nonzero
    ‖want‖)} over ``keys``; a leaf the program lacks counts as 0."""
    rn = {k: float(want[k].double().norm()) for k in keys}
    pn = {k: float(prog[k].double().norm()) if k in prog else 0.0 for k in keys}
    med = statistics.median([v for v in rn.values() if v > 0] or [0.0])
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in keys}


def setup(cell) -> Session:
    return Session(cell)
