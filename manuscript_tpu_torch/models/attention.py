"""Additive-attention LSTM decoder: the teacher-forced training forward,
greedy and beam search (counterpart of ``manuscript_tpu/models/attention.py``).

``forward`` is the teacher-forced pass of training, in plain torch ops under
autograd (the JAX package's ``_cell`` under ``jax.value_and_grad``; neither
package has a backward kernel for the decode step): in train mode the
attention weights pass through dropout (``dropout_p``, rescaled by
1/(1 − p)), and with ``ss_prob`` > 0 each sample, at each step after the
first, feeds back its own previous argmax (of the blank-masked logits,
before dropout) instead of the ground-truth token, on a coin of its own.

Every step of greedy and beam runs ``ops.attention_step.attention_step`` —
the hand-written CUDA step on the card, its plain twin on the CPU. Greedy runs max_len+1
steps; beam runs max_len steps over (B, k) beams, whose k rows of a word
share that word's encoder memory (not repeated k times, as the JAX package
does; the values are the same) with the GNMT length
penalty ((5+t)^α/6^α), finished beams that only continue with EOS at log-prob
0, temperature-scaled logits, BLANK masked at −1e4, and the chosen beams'
logits traced back through the backpointers; each of beam's steps is a
profiler region ``beam.step`` (``utils/profiling.annotate``). Parameters
keep the flax names and layouts; the decoder computes in float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.attention_step import attention_step
from ..utils.profiling import annotate
from .layers import dropout, float32_or_wider, rand_rows
from .rnn import lstm_cell_step

NEG_INF = -1e30
BLANK_MASK = -1e4


def topk_lowest_index(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, ties to the lowest index (as
    ``jax.lax.top_k``; ``torch.topk`` on CUDA does not promise that)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class AttentionDecoder(nn.Module):
    def __init__(
        self,
        enc_dim: int,
        hidden_size: int,
        num_classes: int,
        sos_id: int = 1,
        eos_id: int = 2,
        blank_id: Optional[int] = None,
        dropout_p: float = 0.1,
    ):
        super().__init__()
        e, h, v = enc_dim, hidden_size, num_classes
        self.hidden_size, self.num_classes = h, v
        self.sos_id, self.eos_id, self.blank_id = sos_id, eos_id, blank_id
        self.dropout_p = dropout_p
        shapes = {
            "i2h_kernel": (e, h), "h2h_kernel": (h, h), "h2h_bias": (h,),
            "score_kernel": (h, 1), "lstm_kernel_ih": (e + v, 4 * h),
            "lstm_kernel_hh": (h, 4 * h), "lstm_bias": (4 * h,),
            "gen_kernel": (h, v), "gen_bias": (v,),
        }
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))

    def _step(self, h, c, enc, proj_enc, tok, beam=1):
        return attention_step(
            enc, proj_enc, h, c, tok.to(torch.int32).contiguous(),
            self.h2h_kernel, self.h2h_bias, self.score_kernel.reshape(-1),
            self.lstm_kernel_ih, self.lstm_kernel_hh, self.lstm_bias, beam,
        )

    def _logits(self, h):
        logits = h @ self.gen_kernel + self.gen_bias
        if self.blank_id is not None:
            logits[..., self.blank_id] = BLANK_MASK
        return logits

    def _mask_blank(self, logits):
        """BLANK's logit set to −1e4, out of place (its gradient is zero)."""
        if self.blank_id is None:
            return logits
        col = torch.arange(logits.shape[-1], device=logits.device) == self.blank_id
        return torch.where(col, torch.full((), BLANK_MASK, device=logits.device), logits)

    def _cell(self, h, c, enc, proj_enc, tok, generator=None):
        """One attention + LSTM step in torch ops (``_cell`` of the JAX
        decoder); the token's input row of ``lstm_kernel_ih`` is gathered,
        which is its one-hot product."""
        e_dim = enc.shape[-1]
        proj_h = h @ self.h2h_kernel + self.h2h_bias
        e = torch.tanh(proj_enc + proj_h[:, None, :]) @ self.score_kernel  # (B, T, 1)
        alpha = torch.softmax(e, dim=1)
        if self.training and self.dropout_p > 0:
            alpha = dropout(alpha, self.dropout_p, generator)
        context = torch.sum(alpha * enc, dim=1)
        w_ih = self.lstm_kernel_ih
        x_proj = context @ w_ih[:e_dim] + w_ih[e_dim + tok] + self.lstm_bias
        return lstm_cell_step(self.lstm_kernel_hh, x_proj, h, c)

    def forward(
        self,
        enc: torch.Tensor,
        text_in: torch.Tensor,
        ss_prob: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Teacher-forced logits (B, steps, V), BLANK masked; ``text_in``
        (B, steps) int with SOS at step 0. Dropout and scheduled sampling act
        in train mode only; their draws come from ``generator``."""
        b, steps = text_in.shape
        enc = float32_or_wider(enc)
        proj_enc = enc @ self.i2h_kernel
        text_in = text_in.long()
        use_ss = self.training and ss_prob > 0.0
        h = enc.new_zeros(b, self.hidden_size)
        c = enc.new_zeros(b, self.hidden_size)
        prev = torch.zeros(b, dtype=torch.long, device=enc.device)
        hs = []
        for t in range(steps):
            tok = text_in[:, t]
            if use_ss and t > 0:  # step 0 consumes SOS: never sampled
                coin = rand_rows((b,), generator, enc.device) < ss_prob
                tok = torch.where(coin, prev, tok)
            h, c = self._cell(h, c, enc, proj_enc, tok, generator)
            if use_ss:
                with torch.no_grad():
                    prev = torch.argmax(self._mask_blank(h @ self.gen_kernel + self.gen_bias), -1)
            hs.append(h)
        return self._mask_blank(torch.stack(hs, 1) @ self.gen_kernel + self.gen_bias)

    def _prepare(self, enc):
        enc = enc.float().contiguous()
        return enc, (enc @ self.i2h_kernel).contiguous()

    def greedy(self, enc: torch.Tensor, max_len: int = 25):
        """enc (B, T, E) → (logits (B, max_len+1, V), preds (B, max_len+1))."""
        b = enc.shape[0]
        enc, proj_enc = self._prepare(enc)
        h = enc.new_zeros(b, self.hidden_size)
        c = enc.new_zeros(b, self.hidden_size)
        tok = torch.full((b,), self.sos_id, dtype=torch.int64, device=enc.device)
        all_logits, preds = [], []
        for _ in range(max_len + 1):
            h, c = self._step(h, c, enc, proj_enc, tok)
            logits = self._logits(h)
            tok = torch.argmax(logits, dim=-1)
            all_logits.append(logits)
            preds.append(tok)
        return torch.stack(all_logits, 1), torch.stack(preds, 1)

    def beam(
        self,
        enc: torch.Tensor,
        max_len: int = 25,
        beam_size: int = 5,
        alpha: float = 0.9,
        temperature: float = 1.7,
    ):
        """Batched beam search → (chosen-beam logits (B, max_len, V),
        tokens (B, max_len)); the logits are temperature-scaled and
        blank-masked, as the confidence computation consumes them."""
        b = enc.shape[0]
        k, v, hdim = beam_size, self.num_classes, self.hidden_size
        dev = enc.device
        enc, proj_enc = self._prepare(enc)  # one row per word, shared by its k beams
        bidx = torch.arange(b, device=dev)[:, None]

        tok = torch.full((b, k), self.sos_id, dtype=torch.int64, device=dev)
        scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
        scores[:, 0] = 0.0
        h = enc.new_zeros(b, k, hdim)
        c = enc.new_zeros(b, k, hdim)
        finished = torch.zeros(b, k, dtype=torch.bool, device=dev)
        trace = []
        for t in range(max_len):
            with annotate("beam.step"):
                h2, c2 = self._step(
                    h.reshape(b * k, hdim), c.reshape(b * k, hdim), enc, proj_enc,
                    tok.reshape(b * k), beam=k,
                )
                logits = self._logits(h2) / max(temperature, 1e-6)
                log_probs = torch.log_softmax(logits, dim=-1).reshape(b, k, v)
                # finished beams: only EOS continues, at log-prob 0
                log_probs = torch.where(
                    finished[:, :, None], torch.full_like(log_probs, NEG_INF), log_probs
                )
                log_probs[..., self.eos_id] = torch.where(
                    finished, torch.zeros_like(scores), log_probs[..., self.eos_id]
                )
                next_scores = scores[:, :, None] + log_probs
                lp = 1.0
                if alpha > 0:  # f32 like the reference: (5 + (t+1))^α / 6^α
                    lp = float(torch.tensor(6.0 + t, dtype=torch.float32) ** alpha / (6.0**alpha))
                    next_scores = next_scores / lp
                top_scores, top_idx = topk_lowest_index(next_scores.reshape(b, k * v), k)
                parent = top_idx // v
                tok = top_idx % v
                h = h2.reshape(b, k, hdim)[bidx, parent]
                c = c2.reshape(b, k, hdim)[bidx, parent]
                finished = finished[bidx, parent] | (tok == self.eos_id)
                scores = top_scores * lp if alpha > 0 else top_scores
                trace.append((tok, parent, logits.reshape(b, k, v)))

        beam = torch.argmax(scores, dim=-1)
        b1 = bidx[:, 0]
        tokens, out_logits = [], []
        for tok_t, par_t, log_t in reversed(trace):
            tokens.append(tok_t[b1, beam])
            beam = par_t[b1, beam]
            out_logits.append(log_t[b1, beam])
        return torch.stack(out_logits[::-1], 1), torch.stack(tokens[::-1], 1)
