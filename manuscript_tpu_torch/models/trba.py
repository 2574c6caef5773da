"""TRBA recognizer network (counterpart of ``manuscript_tpu/models/trba.py``):
SEResNet31 → mean over height → 2×BiLSTM → attention decoder. ``cast``
moves the CNN and BiLSTMs to a compute dtype while the decoder stays float32,
as the JAX model does."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .attention import AttentionDecoder
from .rnn import BiLSTM
from .seresnet31 import SEResNet31


class TRBAModel(nn.Module):
    def __init__(
        self,
        num_classes: int,
        hidden_size: int = 256,
        sos_id: int = 1,
        eos_id: int = 2,
        blank_id: Optional[int] = None,
        cnn_stage_plan: str = "full",
        cnn_out_channels: Optional[int] = None,
    ):
        super().__init__()
        out_ch = cnn_out_channels or (128 if cnn_stage_plan == "micro" else 512)
        self.cnn = SEResNet31(out_ch, cnn_stage_plan)
        self.enc_rnn1 = BiLSTM(out_ch, hidden_size, hidden_size)
        self.enc_rnn2 = BiLSTM(hidden_size, hidden_size, hidden_size)
        self.decoder = AttentionDecoder(
            hidden_size, hidden_size, num_classes, sos_id, eos_id, blank_id
        )

    def cast(self, dtype: torch.dtype) -> "TRBAModel":
        for m in (self.cnn, self.enc_rnn1, self.enc_rnn2):
            m.to(dtype)
        return self

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) normalized → (B, W', hidden)."""
        f = self.cnn(x.permute(0, 3, 1, 2)).mean(dim=2)  # height pool
        return self.enc_rnn2(self.enc_rnn1(f.transpose(1, 2)))

    def greedy(self, x, max_len: int = 25):
        return self.decoder.greedy(self.encode(x), max_len=max_len)

    def beam(self, x, max_len=25, beam_size=8, alpha=0.9, temperature=1.7):
        return self.decoder.beam(self.encode(x), max_len, beam_size, alpha, temperature)
