"""Driver ``recognize``: the TRBA recognizer over word strips, in a closed
loop with one caller.

The traffic's parameters: ``batch_size`` (strips a call), ``warmup_calls``,
``strips`` (the pool the calls cycle through, drawn from the seed on the
card: white-padded, left-aligned words of ``min_width`` to full width),
``keep_per_call`` and ``check_strips`` (the sample compared with the
reference; a traced run keeps ``check_strips / trace_calls`` of each call),
``trace_calls``. The configuration gives the model's sizes and decoding.

A call is ``TRBA.recognize_tensor`` with the configuration's beam search on
``batch_size`` strips that are already on the card (the page pipeline's
phase B makes this call on the crops it cut on the card); the caller waits
for the token ids and the confidences and decodes the texts with
``TRBA.decode``.

The check, after the window: a sample of the window's strips drawn from the
seed (``keep_per_call`` answers of each call, ``check_strips`` of those),
with the strip of the longest text in it, runs through the plain
reference (float32, TF32 off): its encoder, the decoder teacher-forced along
the program's tokens, and its own beam search. It compares, under the
configuration's ``limits``:

* ``wrong_or_missing``: calls that returned another number of results than
  strips, and sampled texts that are not the reference's decoding of their
  tokens (exact: limit 0);
* ``conf_gap``: the widest relative gap between a sampled strip's confidence
  and the reference's confidence of the same tokens (the mean probability
  of the tokens up to the first EOS, at the decoding temperature);
* ``beam_gap``: the mean over the sampled strips of the amount (nats, 0 if
  none) by which the reference's score of the program's path (the sum of
  its tokens' log-probabilities up to the first EOS) lies below the best
  path of the reference's beam search. The mean, not the widest: a near-tie
  that rounding flips sends one strip's beam down another path, which can
  end below the best by as much as greedy decoding does (PERF.md); the
  widest and the count of strips below by more than 1e-4 are notes.
"""

from __future__ import annotations

import gc
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import counts
from perfbench.harness import Check
from perfbench.precision import plain_float32
from perfbench.reference import trba as ref
from perfbench.weights import layout_of, make_weights

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_strips(n: int, h: int, w: int, min_width: float, seed: int, device) -> torch.Tensor:
    """(n, h, w, 3) uint8 word strips: ink strokes on paper, left-aligned,
    white (255) to the right of each word, as a letterboxing segmenter pads."""
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(n, 6, generator=g, device=device)
    low = torch.randn(n, 1, max(h // 8, 1), max(w // 4, 1), generator=g, device=device)
    field = F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)[:, 0]
    rows = torch.linspace(-1.0, 1.0, h, device=device)[None, :, None]
    body = (rows.abs() < 0.35 + 0.4 * u[:, 0, None, None]).float()  # x-height and ascenders
    ink = torch.sigmoid(6.0 * (field - 0.5)) * body
    noise = torch.randn(n, h, w, generator=g, device=device)
    paper = 228.0 + 20.0 * u[:, 1, None, None] + 3.0 * noise
    gray = paper - ink * (110.0 + 90.0 * u[:, 2, None, None])
    width = (w * (min_width + (1.0 - min_width) * u[:, 3])).long()
    gray = torch.where(torch.arange(w, device=device)[None, None, :] < width[:, None, None], gray,
                       torch.full_like(gray, 255.0))
    tint = torch.stack([torch.zeros_like(u[:, 4]), 4.0 * (u[:, 4] - 0.5), 6.0 * (u[:, 5] - 0.5)], 1)
    img = gray[..., None] + tint[:, None, None, :] * (gray[..., None] < 255.0)
    return img.round().clamp(0, 255).to(torch.uint8)


class Session:
    unit = "words"

    def __init__(self, cell):
        from manuscript_tpu_torch.recognizers.trba import TRBA

        self.cell = cell
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr = cfg, tr
        self.bs = int(tr["batch_size"])
        dtype = DTYPES[cfg["dtype"]] if cell.variant is None else DTYPES[cell.variant]
        self.trba = TRBA(device=cell.device, dtype=dtype, allow_random_init=True,
                         max_length=cfg["max_length"], hidden_size=cfg["hidden_size"],
                         img_h=cfg["img_h"], img_w=cfg["img_w"], cnn_stage_plan=cfg["cnn_stage_plan"])
        if list(self.trba.itos) != list(cfg["itos"]):
            raise ValueError("perfbench: the recognizer's charset is not the configuration's")
        want = ref.layout(cfg)
        if layout_of(self.trba.model) != want:
            raise ValueError("perfbench: the recognizer's weights do not have the configuration's layout")
        self.weights = make_weights(want, cell.seed, cell.device)
        self.trba.model.load_state_dict(self.weights)
        self.strips_dev = make_strips(int(tr["strips"]), cfg["img_h"], cfg["img_w"],
                                      float(tr["min_width"]), cell.seed, cell.device)
        self.i = 0
        # a traced run makes few calls: it keeps enough of each to compare as many strips
        self.keep = (-(-int(tr["check_strips"]) // int(tr["trace_calls"])) if cell.trace
                     else int(tr["keep_per_call"]))
        self._reset()
        for _ in range(int(tr["warmup_calls"])):
            self.call()
        self._reset()

    def _reset(self) -> None:
        """Forget the calls made so far: counters, kept answers, longest text."""
        self.calls, self.failed, self.kept, self.longest = 0, 0, [], None

    def _recognize(self, idx: List[int]):
        """→ (answers [{"text", "confidence"}], token ids (n, steps))."""
        cfg = self.cfg
        lo = idx[0]
        strips = (self.strips_dev[lo:lo + len(idx)] if idx == list(range(lo, lo + len(idx)))
                  else self.strips_dev[idx])
        preds, confs = self.trba.recognize_tensor(strips, "beam", cfg["beam_size"], cfg["alpha"],
                                                  cfg["temperature"])
        ids, confs = preds.cpu().numpy(), confs.cpu().numpy()
        out = [{"text": self.trba.decode(p), "confidence": float(np.clip(c, 0.0, 1.0))}
               for p, c in zip(ids, confs)]
        return out, ids

    def call(self) -> int:
        """One call of ``batch_size`` strips; keeps ``keep_per_call`` of its
        answers, drawn from the seed, and the longest text so far."""
        n = int(self.strips_dev.shape[0])
        start = (self.i * self.bs) % n
        idx = [(start + j) % n for j in range(self.bs)]
        out, ids = self._recognize(idx)
        self.calls += 1
        if len(out) != len(idx) or len(ids) != len(idx):
            self.failed += 1
        n_ok = min(len(out), len(ids))
        rng = np.random.default_rng([self.cell.seed, 7, self.i])
        rows = rng.choice(n_ok, size=min(self.keep, n_ok), replace=False) if n_ok else []
        self.kept += [(idx[r], out[r], ids[r]) for r in rows]
        if n_ok:
            r = max(range(n_ok), key=lambda j: len(out[j]["text"]))
            if self.longest is None or len(out[r]["text"]) > len(self.longest[1]["text"]):
                self.longest = (idx[r], out[r], ids[r])
        self.i += 1
        return len(out)

    def finish(self) -> None:
        pass  # each call waits for its texts

    def counts(self) -> Dict[str, Any]:
        cfg = self.cfg
        _, t = counts.trba_encode_flops(cfg["img_h"], cfg["img_w"], cfg["cnn_stage_plan"],
                                        cfg["cnn_out_channels"], cfg["hidden_size"])
        return {"call_flops": counts.trba_call_flops(self.bs, cfg), "words": self.bs, "t": t,
                "rows": self.bs * cfg["beam_size"]}

    def free(self) -> None:
        self.trba = None
        gc.collect()
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Check:
        cfg, limits = self.cfg, self.cfg["limits"]
        chk = Check()
        rng = np.random.default_rng([self.cell.seed, 8])
        n = len(self.kept)
        pick = [self.kept[i] for i in sorted(rng.choice(n, size=min(int(self.tr["check_strips"]), n),
                                                        replace=False))] if n else []
        if self.longest is not None:
            pick.append(self.longest)
        wrong = sum(out["text"] != ref.decode_text(ids, cfg["itos"], cfg["pad_id"], cfg["eos_id"])
                    for _, out, ids in pick)
        chk.add("wrong_or_missing", self.failed + wrong, limits["wrong_or_missing"])
        if not pick:
            chk.add("conf_gap", float("inf"), limits["conf_gap"])
            chk.add("beam_gap", float("inf"), limits["beam_gap"])
            return chk
        conf_gaps, beam_gaps = [], []
        with plain_float32():
            for b in range(0, len(pick), 64):
                block = pick[b:b + 64]
                strips = self.strips_dev[[j for j, _, _ in block]]
                tok = torch.as_tensor(np.stack([ids for _, _, ids in block]), device=strips.device).long()
                conf_p = torch.tensor([out["confidence"] for _, out, _ in block], dtype=torch.float64,
                                      device=strips.device)
                enc = ref.encode(self.weights, cfg, strips)
                lp = ref.forced_log_probs(self.weights, cfg, enc, tok)
                conf_r = ref.path_confidence(lp, tok, cfg["eos_id"]).double()
                conf_gaps.append(((conf_p - conf_r).abs() / conf_r).max())
                best, _ = ref.beam_search(self.weights, cfg, enc)
                beam_gaps.append((best - ref.path_log_prob(lp, tok, cfg["eos_id"])).clamp_min(0.0))
        chk.add("conf_gap", float(torch.stack(conf_gaps).max()), limits["conf_gap"])
        below = torch.cat(beam_gaps).double()
        chk.add("beam_gap", float(below.mean()), limits["beam_gap"])
        chk.notes.append(f"beam: widest {float(below.max())!r} nats, "
                         f"{int((below > 1e-4).sum())} strips below the best by more than 1e-4")
        chk.notes.append(f"{len(pick)} strips compared, kept from {self.calls} calls")
        return chk


def setup(cell) -> Session:
    return Session(cell)
