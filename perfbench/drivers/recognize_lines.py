"""Driver ``recognize_lines``: the TrOCR recognizer over handwritten line
images, in a closed loop with one caller.

The traffic's parameters: ``batch_size`` (lines a call), ``warmup_calls``,
``lines`` (the pool the calls cycle through, drawn from the seed on the
card: ink strokes of one line over ``min_width`` to all of a
``line_h`` × ``line_w`` strip, squashed to the model's square input as
TrOCR's processor resizes a line), ``keep_per_call`` and ``check_lines``
(the sample compared with the reference; a traced run keeps
``check_lines / trace_calls`` of each call), ``trace_calls``. The
configuration gives the model's widths (Hugging Face's ``config.json``
groups) and decoding.

A call is ``TrOCR.recognize_tensor`` with the configuration's beam search
on ``batch_size`` lines already on the card; the caller waits for the
token ids and the confidences and decodes each text with ``TrOCR.decode``.
A line's text counts as one of the ``words`` of ``words_per_s``.

The check, after the window: a sample of the window's lines drawn from the
seed (``keep_per_call`` of each call, with the logits of their chosen
paths, ``check_lines`` of those), with the line of the longest text in it,
runs through the plain reference (``reference/trocr.py``, float32, TF32
off): its encoder, its decoder teacher-forced along the program's tokens,
and its own beam search. Compared, under the configuration's ``limits``:

* ``wrong_or_missing``: calls that returned another number of results than
  lines, and sampled texts that are not the stand-in decoding of their
  tokens (exact: limit 0);
* ``conf_gap``: the widest relative gap between a sampled line's
  confidence and the reference's confidence of the same tokens;
* ``beam_gap``: the mean over the sampled lines of the nats (0 if none) by
  which the reference's score of the program's path lies below the best
  path of the reference's beam search (the mean: a near-tie that rounding
  flips sends one line down another path);
* ``logit_gap``: the widest gap, over the sampled lines and their steps up
  to the first EOS, between the program's log-probabilities of the whole
  vocabulary along its chosen path and the reference's teacher-forced ones,
  over the spread (standard deviation) of the reference's at that step.

Controls (``cell.variant``, set by ``perfbench/controls.py``): ``tf32``
runs the program's matrix products in TF32, ``bfloat16`` the model in
bfloat16; the fault ``one_beam`` keeps one beam, which is greedy decoding.
"""

from __future__ import annotations

import gc
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import counts_trocr
from perfbench.drivers.recognize import make_strips
from perfbench.harness import Check
from perfbench.precision import plain_float32
from perfbench.reference import trocr as ref
from perfbench.weights import layout_of, make_weights

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_lines(n: int, h: int, w: int, side: int, min_width: float, seed: int, device) -> torch.Tensor:
    """(n, side, side, 3) uint8 line images: ``make_strips``' ink strokes on
    paper at (h, w), white to the right of the line, squashed to side²."""
    out = torch.empty(n, side, side, 3, dtype=torch.uint8, device=device)
    for i in range(0, n, 64):
        m = min(64, n - i)
        strips = make_strips(m, h, w, min_width, seed * 7919 + i, device).float().permute(0, 3, 1, 2)
        sq = F.interpolate(strips, size=(side, side), mode="bilinear", align_corners=False, antialias=True)
        out[i:i + m] = sq.permute(0, 2, 3, 1).round().clamp(0, 255).to(torch.uint8)
    return out


class Session:
    unit = "words"

    def __init__(self, cell):
        from manuscript_tpu_torch.models.trocr import TrOCRConfig, TrOCRModel
        from manuscript_tpu_torch.recognizers.trocr import TrOCR

        self.cell = cell
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr = cfg, tr
        self.bs = int(tr["batch_size"])
        self.variant = cell.variant
        dtype = DTYPES["bfloat16" if cell.variant == "bfloat16" else cfg["dtype"]]
        self.saved_tf32 = torch.backends.cuda.matmul.allow_tf32
        if cell.variant == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        config = TrOCRConfig.from_hf(cfg)
        want = ref.layout(cfg)
        with torch.device("meta"):
            if layout_of(TrOCRModel(config)) != want:
                raise ValueError("perfbench: the recognizer's weights do not have the configuration's layout")
        self.weights = make_weights(want, cell.seed, cell.device)
        self.trocr = TrOCR(self.weights, device=cell.device, dtype=dtype, max_length=cfg["max_length"],
                           config=config)
        side = cfg["encoder"]["image_size"]
        self.lines_dev = make_lines(int(tr["lines"]), int(tr["line_h"]), int(tr["line_w"]), side,
                                    float(tr["min_width"]), cell.seed, cell.device)
        self.i = 0
        self.keep = (-(-int(tr["check_lines"]) // int(tr["trace_calls"])) if cell.trace
                     else int(tr["keep_per_call"]))
        self._reset()
        for _ in range(int(tr["warmup_calls"])):
            self.call()
        self._reset()

    def _reset(self) -> None:
        """Forget the calls made so far: counters, kept answers, longest text."""
        self.calls, self.failed, self.kept, self.longest = 0, 0, [], None

    def call(self) -> int:
        """One call of ``batch_size`` lines; keeps ``keep_per_call`` of its
        answers, drawn from the seed, with their paths' logits, and the
        longest text so far."""
        cfg = self.cfg
        n = int(self.lines_dev.shape[0])
        start = (self.i * self.bs) % n
        idx = [(start + j) % n for j in range(self.bs)]
        lines = (self.lines_dev[start:start + self.bs] if start + self.bs <= n else self.lines_dev[idx])
        beams = 1 if self.variant == "one_beam" else cfg["beam_size"]
        preds, confs, logits = self.trocr.recognize_tensor(lines, "beam", beams, cfg["alpha"],
                                                           cfg["temperature"], return_logits=True)
        ids, confs = preds.cpu().numpy(), confs.cpu().numpy()
        out = [{"text": self.trocr.decode(p), "confidence": float(c)} for p, c in zip(ids, np.clip(confs, 0, 1))]
        self.calls += 1
        if len(out) != len(idx) or len(ids) != len(idx):
            self.failed += 1
        n_ok = min(len(out), len(ids))
        rng = np.random.default_rng([self.cell.seed, 7, self.i])
        rows = sorted(rng.choice(n_ok, size=min(self.keep, n_ok), replace=False)) if n_ok else []
        if n_ok:
            r = max(range(n_ok), key=lambda j: len(out[j]["text"]))
            if self.longest is None or len(out[r]["text"]) > len(self.longest[1]["text"]):
                self.longest = (idx[r], out[r], ids[r], logits[r].clone())
        kept = logits[torch.as_tensor(rows, device=logits.device, dtype=torch.long)] if rows else None
        self.kept += [(idx[r], out[r], ids[r], kept[j]) for j, r in enumerate(rows)]
        self.i += 1
        return len(out)

    def finish(self) -> None:
        pass  # each call waits for its texts

    def counts(self) -> Dict[str, Any]:
        return {"call_flops": counts_trocr.call_flops(self.bs, self.cfg), "lines": self.bs}

    def free(self) -> None:
        self.trocr = None
        torch.backends.cuda.matmul.allow_tf32 = self.saved_tf32
        gc.collect()
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Check:
        cfg, limits = self.cfg, self.cfg["limits"]
        eos = cfg["decoder"]["eos_token_id"]
        chk = Check()
        rng = np.random.default_rng([self.cell.seed, 8])
        n = len(self.kept)
        pick = [self.kept[i] for i in sorted(rng.choice(n, size=min(int(self.tr["check_lines"]), n),
                                                        replace=False))] if n else []
        if self.longest is not None:
            pick.append(self.longest)
        wrong = sum(out["text"] != ref.stand_in_text(list(ids), eos) for _, out, ids, _ in pick)
        chk.add("wrong_or_missing", self.failed + wrong, limits["wrong_or_missing"])
        if not pick:
            for name in ("conf_gap", "beam_gap", "logit_gap"):
                chk.add(name, float("inf"), limits[name])
            return chk
        conf_gaps: List[torch.Tensor] = []
        beam_gaps: List[torch.Tensor] = []
        logit_gaps: List[torch.Tensor] = []
        with plain_float32():
            for b in range(0, len(pick), 8):
                block = pick[b:b + 8]
                lines = self.lines_dev[[j for j, _, _, _ in block]]
                dev = lines.device
                tok = torch.as_tensor(np.stack([ids for _, _, ids, _ in block]), device=dev).long()
                conf_p = torch.tensor([out["confidence"] for _, out, _, _ in block], dtype=torch.float64,
                                      device=dev)
                lp_p = torch.log_softmax(torch.stack([lg for _, _, _, lg in block]).float(), -1)
                enc = ref.encode(self.weights, cfg, lines)
                lp = ref.forced_log_probs(self.weights, cfg, enc, tok)
                conf_r = ref.path_confidence(lp, tok, eos).double()
                conf_gaps.append(((conf_p - conf_r).abs() / conf_r).max())
                upto = path_mask(tok, eos)
                gap = (lp_p - lp).abs().amax(-1) / lp.std(-1)
                logit_gaps.append(gap[upto].max())
                best, _ = ref.beam_search(self.weights, cfg, enc)
                beam_gaps.append((best - ref.path_log_prob(lp, tok, eos)).clamp_min(0.0))
        chk.add("conf_gap", float(torch.stack(conf_gaps).max()), limits["conf_gap"])
        below = torch.cat(beam_gaps).double()
        chk.add("beam_gap", float(below.mean()), limits["beam_gap"])
        chk.add("logit_gap", float(torch.stack(logit_gaps).max()), limits["logit_gap"])
        chk.notes.append(f"beam: widest {float(below.max())!r} nats, "
                         f"{int((below > 1e-4).sum())} lines below the best by more than 1e-4")
        chk.notes.append(f"{len(pick)} lines compared, kept from {self.calls} calls")
        return chk


def path_mask(tokens: torch.Tensor, eos_id: int) -> torch.Tensor:
    """(B, steps) bool: the steps up to and including each row's first EOS."""
    steps = tokens.shape[1]
    is_eos = tokens == eos_id
    first = torch.where(is_eos.any(1), is_eos.int().argmax(1) + 1, torch.full_like(tokens[:, 0], steps))
    return torch.arange(steps, device=tokens.device)[None] < first[:, None]


def setup(cell) -> Session:
    return Session(cell)
