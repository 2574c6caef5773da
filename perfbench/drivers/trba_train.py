"""Driver ``trba_train``: the TRBA trainer's step, ``trba_train.train_step``,
on a ``TRBAModel`` and an optimizer built as ``trba_train.train`` builds
them: every parameter trained, ``build_trba_optimizer("adam", lr, 0, clip)``
(the trainer ``Config``'s defaults, given here as the traffic's ``lr`` and
``grad_clip``), no scheduled sampling, float32, in train mode with the
model's dropout (the encoder's output and the decoder's attention weights,
``dropout``), drawn from one ``torch.Generator`` of the card seeded from
the seed, as the trainer draws them.

The traffic's parameters: ``batch_size``, ``batches`` (made on the card
from the seed: word strips of ``min_width`` to full width, as the
recognizer's cells draw them, and labels of ``label_length`` tokens over
the configuration's characters, packed as the trainer packs them: SOS,
the ids, PAD in ``text_in``; the ids, EOS, PAD in ``target_y``; the steps
run back to back over them), ``check_steps`` (the first steps, which the
reference follows) and ``trace_calls``.

The check: the reference (``reference/trba_train.py``, float32, TF32 off)
follows the first ``check_steps`` steps (the set-up's) from the same
weights, batches and dropout draws (the generator's state before each of
the program's steps). Compared, under the configuration's ``limits``:

* ``loss_gap``: the widest relative gap of a checked step's loss;
* ``grad_gap.<group>``: the first gradient as the optimizer gets it, after
  the clip (the program's: Adam's first moment after one step over
  1 − β1), as ‖program − reference‖ / ‖reference‖ over the group's leaves
  together; the groups ``rnn`` (the two BiLSTMs) and ``decoder``;
* ``delta_gap.<group>``: the same of the parameters' change over the
  checked steps;
* ``witness_grad_gap``: the widest leaf's relative gap of the first
  gradient of one step on the first ``WITNESS_ROWS`` rows of the first
  batch, the program and the reference both in float64 (the program's
  model cast, as the trainer allows), from the first step's dropout draws.

The CNN's float32 gaps are not compared: the train-mode SEResNet31's
gradient is so ill-conditioned that float32 rounding alone parts the
program from the reference by about 2e-3 over the group, the program's
TF32 convolutions by about 0.08, and the float32 reference's widest leaf
from float64 by up to 0.18 (PERF.md); no control reads ten times the TF32
gap. They are printed as notes, with that float32 reference's gap on the
witness rows, which the witness's limit lies far below. The witness holds
every leaf, the CNN's with the rest.

Controls and faults (``cell.variant``, set by ``perfbench/controls.py``):
``reference_bf16`` puts the reference under bfloat16 autocast in the
program's place (in the witness too), ``half_batch`` trains the program on
the first half of each batch, ``cnn_grad_scaled`` hands the optimizer the
CNN's gradients times 1.1.
"""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from perfbench import counts_trba_train
from perfbench.drivers.recognize import make_strips
from perfbench.harness import Check
from perfbench.precision import plain_float32
from perfbench.reference import trba as ref_model
from perfbench.reference import trba_train as ref
from perfbench.weights import layout_of, make_weights

GROUPS = {"cnn": ("cnn.",), "rnn": ("enc_rnn1.", "enc_rnn2."), "decoder": ("decoder.",)}
COMPARED = ("rnn", "decoder")  # the groups whose float32 gaps carry limits
WITNESS_ROWS = 32  # enough for every path of the step; float64 is slow on the card


def make_labels(n: int, max_len: int, lengths, n_classes: int, first: int, seed: int, device):
    """(lengths (n,), ids (n, max_len), positions (1, max_len + 1)): ids drawn
    uniformly from [first, n_classes), ``lengths`` (low, high) tokens a label."""
    g = torch.Generator(device=device).manual_seed(seed)
    length = torch.randint(lengths[0], lengths[1] + 1, (n,), generator=g, device=device)
    ids = torch.randint(first, n_classes, (n, max_len), generator=g, device=device)
    pos = torch.arange(max_len + 1, device=device)[None]
    return length, ids, pos


class Session:
    unit = "samples"
    failed = 0  # a step that fails raises

    def __init__(self, cell):
        cfg, tr = cell.config, cell.traffic
        self.cell, self.tr = cell, tr
        self.cfg = {**cfg, "lr": tr["lr"], "grad_clip": tr["grad_clip"], "dropout": tr["dropout"],
                    "limits": tr["limits"]}
        dev = cell.device
        self.bs = int(tr["batch_size"])
        self.batches = self._make_batches()
        self.weights = make_weights(ref_model.layout(cfg), cell.seed, dev)
        self.trainable = [k for k in self.weights if not k.endswith(("running_mean", "running_var"))]
        self.i = 0
        n_check = int(tr["check_steps"])
        self.gen = torch.Generator(device=dev).manual_seed(cell.seed)
        self.gen_states = []
        if cell.variant == "reference_bf16":  # the control: the reference in bfloat16 in the program's place
            trainer = ref.Trainer(self.cfg, self.weights, self.trainable)
            with torch.autocast(dev.type, dtype=torch.bfloat16):
                for step in range(n_check):
                    self.gen_states.append(self.gen.get_state())
                    trainer.step(self.batch(step), self.gen_states[-1])
            self.readings = (trainer.losses, trainer.first_gradient,
                             {k: p.detach() for k, p in trainer.params.items()})
            self.runs_window = False
            return
        self._build()
        losses = []
        for step in range(n_check):
            self.gen_states.append(self.gen.get_state())
            losses.append(self._step())
            if step == 0:
                first = first_gradient(self.opt_state)
        after = {k: p.detach().clone() for k, p in self.params.items()}
        self.readings = ([float(x) for x in losses], first, after)
        self.finish()

    def _make_batches(self) -> List[Dict[str, torch.Tensor]]:
        cfg, tr, dev, seed = self.cell.config, self.tr, self.cell.device, self.cell.seed
        n, max_len = int(tr["batches"]) * self.bs, cfg["max_length"]
        strips = make_strips(n, cfg["img_h"], cfg["img_w"], float(tr["min_width"]), seed, dev)
        itos = cfg["itos"]
        length, ids, pos = make_labels(n, max_len, tr["label_length"], len(itos), cfg["eos_id"] + 1,
                                       seed * 7919 + 1, dev)
        text_in = torch.full((n, max_len + 1), cfg["pad_id"], dtype=torch.int32, device=dev)
        text_in[:, 0] = cfg["sos_id"]
        text_in[:, 1:] = torch.where(pos[:, 1:] <= length[:, None], ids, text_in[:, 1:])
        target_y = torch.full((n, max_len + 1), cfg["pad_id"], dtype=torch.int32, device=dev)
        target_y[:, :max_len] = torch.where(pos[:, :max_len] < length[:, None], ids, target_y[:, :max_len])
        target_y[torch.arange(n, device=dev), length] = cfg["eos_id"]
        return [{"image": strips[j:j + self.bs], "text_in": text_in[j:j + self.bs],
                 "target_y": target_y[j:j + self.bs]} for j in range(0, n, self.bs)]

    def _build(self) -> None:
        self.model, self.tx, self.params, self.opt_state = self._program(self.weights)

    def _program(self, weights: Dict[str, torch.Tensor]):
        """(model, optimizer, parameters, optimizer state) as ``train``
        builds them, from ``weights`` and in their dtype."""
        from manuscript_tpu_torch.models.trba import TRBAModel
        from manuscript_tpu_torch.train.optim import build_trba_optimizer

        cfg = self.cfg
        with torch.device(self.cell.device):
            model = TRBAModel(len(cfg["itos"]), cfg["hidden_size"], cfg["sos_id"], cfg["eos_id"], None,
                              cfg["cnn_stage_plan"], enc_dropout_p=cfg["dropout"],
                              dec_dropout_p=cfg["dropout"])
        if layout_of(model) != ref_model.layout(cfg):
            raise ValueError("perfbench: the recognizer's weights do not have the configuration's layout")
        model.to(next(iter(weights.values())).dtype).load_state_dict(weights)
        tx = build_trba_optimizer("adam", cfg["lr"], 0.0, cfg["grad_clip"], None)
        if self.cell.variant == "cnn_grad_scaled":
            update = tx.update
            tx = tx._replace(update=lambda g, state, p: update(
                {k: v * 1.1 if k.startswith("cnn.") else v for k, v in g.items()}, state, p))
        params = dict(model.named_parameters())
        return model, tx, params, tx.init(params)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        return self.batches[step % len(self.batches)]

    def _step(self):
        loss, self.opt_state = self._train_step(self.model, self.tx, self.opt_state, self.params,
                                                self.batch(self.i), self.gen)
        self.i += 1
        return loss

    def _train_step(self, model, tx, opt_state, params, batch, gen):
        """One of the program's steps → (loss, the new optimizer state)."""
        from manuscript_tpu_torch.train import trba_train

        if self.cell.variant == "half_batch":
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return trba_train.train_step(model, tx, opt_state, params, batch, self.cfg["pad_id"], 0.0, 1.0, gen)

    def call(self) -> int:
        self._step()
        return self.bs

    def finish(self) -> None:
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)

    def counts(self) -> Dict:
        return {"traced_flops": int(self.tr["trace_calls"]) * counts_trba_train.train_step_flops(self.bs, self.cfg)}

    def free(self) -> None:
        self.model = self.tx = self.opt_state = self.params = None
        gc.collect()
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Check:
        limits = self.cfg["limits"]
        losses, first, after = self.readings
        n_check = int(self.tr["check_steps"])
        with plain_float32():
            trainer = ref.Trainer(self.cfg, self.weights, self.trainable)
            for step in range(n_check):
                trainer.step(self.batch(step), self.gen_states[step])
        chk = Check()
        gaps = [abs(a - b) / abs(b) if np.isfinite(a) else float("inf") for a, b in zip(losses, trainer.losses)]
        chk.add("loss_gap", max(gaps) if len(gaps) == n_check else float("inf"), limits["loss_gap"])
        want_delta = {k: trainer.params[k].detach() - self.weights[k] for k in self.trainable}
        got_delta = {k: after[k] - self.weights[k] for k in self.trainable}
        for name, got, want in (("grad_gap", first, trainer.first_gradient), ("delta_gap", got_delta, want_delta)):
            for group, prefixes in GROUPS.items():
                gap = relative_gap(got, want, [k for k in self.trainable if k.startswith(prefixes)])
                if group in COMPARED:
                    chk.add(f"{name}.{group}", gap, limits[f"{name}.{group}"])
                else:
                    chk.notes.append(f"{name}.{group} {gap!r} (not compared)")
        chk.notes.append("losses: program " + ", ".join(f"{x!r}" for x in losses)
                         + "; reference " + ", ".join(f"{x!r}" for x in trainer.losses))
        del trainer
        chk.add("witness_grad_gap", self._witness(chk.notes), limits["witness_grad_gap"])
        return chk

    def _witness(self, notes: List[str]) -> float:
        """``witness_grad_gap``; the float32 reference's own widest leaf gap
        from the float64 reference, and the leaves, go to ``notes``."""
        batch = {k: v[:WITNESS_ROWS] for k, v in self.batch(0).items()}

        def reference(dtype, bfloat16=False):
            t = ref.Trainer(self.cfg, {k: v.to(dtype) for k, v in self.weights.items()}, self.trainable)
            with torch.autocast(self.cell.device.type, dtype=torch.bfloat16, enabled=bfloat16):
                t.step(batch, self.gen_states[0])
            return t.first_gradient

        with plain_float32():
            want = reference(torch.float64)
            f32 = widest_leaf(reference(torch.float32), want, self.trainable)
            if self.cell.variant == "reference_bf16":
                got = reference(torch.float32, bfloat16=True)
            else:
                model, tx, params, state = self._program({k: v.double() for k, v in self.weights.items()})
                gen = torch.Generator(device=self.cell.device)
                gen.set_state(self.gen_states[0])
                got = first_gradient(self._train_step(model, tx, state, params, batch, gen)[1])
                del model, tx, params, state
        gap = widest_leaf(got, want, self.trainable)
        notes.append(f"witness_grad_gap {gap[0]!r} at {gap[1]}; reference_f32 {f32[0]!r} at {f32[1]}")
        return gap[0]


def first_gradient(opt_state) -> Dict[str, torch.Tensor]:
    """The gradient the clipped Adam got at its first step: its first moment
    over 1 − β1."""
    return {k: m.detach() / 0.1 for k, m in opt_state["1"]["0"]["mu"].items()}


def widest_leaf(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], keys) -> tuple:
    """(the largest ‖got − want‖ / ‖want‖ of a leaf of ``keys``, that leaf),
    in float64; a leaf whose ``want`` is zero reads 0 if ``got`` is too,
    inf if not, as does a missing leaf or a result that is not finite."""
    out = (0.0, "")
    for k in keys:
        if k not in got:
            return float("inf"), k
        diff, norm = float((got[k].double() - want[k].double()).norm()), float(want[k].double().norm())
        gap = diff / norm if norm > 0 else (0.0 if diff == 0 else float("inf"))
        if not np.isfinite(gap):
            return float("inf"), k
        out = max(out, (gap, k))
    return out


def relative_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], keys) -> float:
    """‖got − want‖ / ‖want‖ over ``keys`` together, in float64; inf if a
    leaf is missing or the result is not finite."""
    if any(k not in got for k in keys):
        return float("inf")
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in keys)
    den = sum(float((want[k].double() ** 2).sum()) for k in keys)
    gap = (num / den) ** 0.5 if den > 0 else float("inf")
    return gap if np.isfinite(gap) else float("inf")


def setup(cell) -> Session:
    return Session(cell)
