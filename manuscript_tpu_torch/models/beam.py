"""Beam-search bookkeeping shared by the port's decoders (TRBA's attention
LSTM and TrOCR's transformer).

``Beam`` keeps (B, k) beams over a vocabulary of V tokens. Each step the
decoder gives it the raw logits of its B·k rows; ``advance`` selects the
kept beams with ``ops/beam_select.beam_select`` (K8 on a card, its plain
version on the CPU): it scales the logits by the temperature, takes their
log-softmax, lets a finished beam continue only with EOS at log-prob 0,
adds the beams' scores, divides by the GNMT length scale ((5 + t + 1)/6)^α
in float32, keeps the k best of k·V with ties to the lowest index, splits
each into its parent beam and its token, and returns the parents. The
decoder then reorders its own state by them (``reorder``: TRBA its LSTM's
h and c, TrOCR its self-attention cache). The trace keeps each step's raw
logits; ``backtrace`` follows the parents back from each row's best beam →
(the chosen path's logits (B, steps, V) divided by the temperature, the
same float32 division of the same values as a step's, its tokens (B,
steps)). The selection runs in the profiler region ``beam.advance``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..ops.beam_select import NEG_INF, beam_select, topk_lowest_index  # noqa: F401  (re-exported)
from ..utils.profiling import annotate


def length_scale(t: int, alpha: float) -> float:
    """The GNMT length scale after step ``t`` (0-based), (5 + t + 1)^α / 6^α,
    in float32 as the JAX package computes it."""
    return float(torch.tensor(6.0 + t, dtype=torch.float32) ** alpha / (6.0**alpha))


class Beam:
    def __init__(self, b: int, k: int, v: int, start_id: int, eos_id: int, device):
        self.b, self.k, self.v, self.eos_id = b, k, v, eos_id
        self.rows = torch.arange(b, device=device)[:, None]
        self.tok = torch.full((b, k), start_id, dtype=torch.int64, device=device)
        self.scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=device)
        self.scores[:, 0] = 0.0
        self.finished = torch.zeros(b, k, dtype=torch.bool, device=device)
        self.parent = None
        self.temperature = 1.0
        self.trace: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []

    def advance(self, logits: torch.Tensor, t: int, alpha: float, temperature: float) -> torch.Tensor:
        """Step ``t`` on the raw logits (B·k, V) → the kept beams' parents
        (B, k); their tokens are ``tok``, their scores ``scores``."""
        with annotate("beam.advance"):
            lp = length_scale(t, alpha) if alpha > 0 else None
            self.parent, self.tok, self.scores, self.finished = beam_select(
                logits, self.scores, self.finished, self.rows, self.eos_id, temperature, lp)
        self.temperature = temperature
        self.trace.append((self.tok, self.parent, logits.reshape(self.b, self.k, self.v)))
        return self.parent

    def reorder(self, x: torch.Tensor) -> torch.Tensor:
        """A decoder's state of B·k rows → (B, k, ...) in the order of the
        beams the last ``advance`` kept."""
        return x.reshape(self.b, self.k, *x.shape[1:])[self.rows, self.parent]

    def backtrace(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (the chosen beams' logits over the temperature (B, steps, V),
        tokens (B, steps))."""
        beam = torch.argmax(self.scores, dim=-1)
        b1 = self.rows[:, 0]
        tokens, out_logits = [], []
        for tok_t, par_t, log_t in reversed(self.trace):
            tokens.append(tok_t[b1, beam])
            beam = par_t[b1, beam]
            out_logits.append(log_t[b1, beam])
        # in place: the stacked path is fresh, and a second (B, steps, V) would
        # raise the call's peak memory by its size
        logits = torch.stack(out_logits[::-1], 1).div_(max(self.temperature, 1e-6))
        return logits, torch.stack(tokens[::-1], 1)
