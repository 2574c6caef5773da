"""Beam-search bookkeeping shared by the port's decoders (TRBA's attention
LSTM and TrOCR's transformer).

``Beam`` keeps (B, k) beams over a vocabulary of V tokens. Each step the
decoder gives it the raw logits of its B·k rows; ``advance`` scales them by
the temperature, takes their log-softmax, lets a finished beam continue only
with EOS at log-prob 0, adds the beams' scores, divides by the GNMT length
scale ((5 + t + 1)/6)^α in float32, keeps the k best of k·V with ties to the
lowest index (``topk_lowest_index``), splits each into its parent beam and
its token, and returns the parents. The decoder then reorders its own state
by them (``reorder``: TRBA its LSTM's h and c, TrOCR its self-attention
cache). ``backtrace`` follows the parents back from each row's best beam →
(the scaled logits of the chosen path (B, steps, V), its tokens (B, steps)).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

NEG_INF = -1e30


def topk_lowest_index(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, ties to the lowest index (as
    ``jax.lax.top_k``; ``torch.topk`` on CUDA does not promise that)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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
        self.trace: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []

    def advance(self, logits: torch.Tensor, t: int, alpha: float, temperature: float) -> torch.Tensor:
        """Step ``t`` on the raw logits (B·k, V) → the kept beams' parents
        (B, k); their tokens are ``tok``, their scores ``scores``."""
        b, k, v = self.b, self.k, self.v
        logits = logits / max(temperature, 1e-6)
        log_probs = torch.log_softmax(logits, dim=-1).reshape(b, k, v)
        # finished beams: only EOS continues, at log-prob 0
        log_probs = torch.where(
            self.finished[:, :, None], torch.full_like(log_probs, NEG_INF), log_probs
        )
        log_probs[..., self.eos_id] = torch.where(
            self.finished, torch.zeros_like(self.scores), log_probs[..., self.eos_id]
        )
        next_scores = self.scores[:, :, None] + log_probs
        lp = 1.0
        if alpha > 0:
            lp = length_scale(t, alpha)
            next_scores = next_scores / lp
        top_scores, top_idx = topk_lowest_index(next_scores.reshape(b, k * v), k)
        self.parent = top_idx // v
        self.tok = top_idx % v
        self.finished = self.finished[self.rows, self.parent] | (self.tok == self.eos_id)
        self.scores = top_scores * lp if alpha > 0 else top_scores
        self.trace.append((self.tok, self.parent, logits.reshape(b, k, v)))
        return self.parent

    def reorder(self, x: torch.Tensor) -> torch.Tensor:
        """A decoder's state of B·k rows → (B, k, ...) in the order of the
        beams the last ``advance`` kept."""
        return x.reshape(self.b, self.k, *x.shape[1:])[self.rows, self.parent]

    def backtrace(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (the chosen beams' scaled logits (B, steps, V), tokens (B, steps))."""
        beam = torch.argmax(self.scores, dim=-1)
        b1 = self.rows[:, 0]
        tokens, out_logits = [], []
        for tok_t, par_t, log_t in reversed(self.trace):
            tokens.append(tok_t[b1, beam])
            beam = par_t[b1, beam]
            out_logits.append(log_t[b1, beam])
        return torch.stack(out_logits[::-1], 1), torch.stack(tokens[::-1], 1)
