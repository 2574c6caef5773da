"""TRBA recognizer network (counterpart of ``manuscript_tpu/models/trba.py``):
SEResNet31 → mean over height → 2×BiLSTM → attention decoder. ``cast``
moves the CNN and BiLSTMs to a compute dtype while the decoder stays float32,
as the JAX model does; under ``torch.autocast`` the decoder runs with
autocast off, in float32, for the same reason.

Train mode is the module's (``model.train()``, where the JAX model takes a
``train`` argument): the BatchNorms use and update
batch statistics, the encoder output passes through dropout
(``enc_dropout_p``, 0.1 as in the JAX model), the decoder's attention weights
through its own (``dec_dropout_p``, 0.1), and the CNN's channel dropout runs
when ``dropblock_p`` > 0. Every draw comes from the ``generator`` given to
``encode``/``forward``.

``use_tps`` puts a TPS rectification (``models/tps.py``, ``tps_fiducials``
points, identity at init) in front of the CNN, as the JAX model's option
does; ``cast`` moves it to the compute dtype with the CNN, as the JAX model
gives it its ``dtype``, and its grid and sampling stay float32."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .attention import AttentionDecoder
from .layers import dropout, float32_or_wider
from .rnn import BiLSTM
from .seresnet31 import SEResNet31


def _no_autocast(t: torch.Tensor):
    return torch.autocast(t.device.type, enabled=False)


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
        enc_dropout_p: float = 0.1,
        dec_dropout_p: float = 0.1,
        dropblock_p: float = 0.0,
        use_tps: bool = False,
        tps_fiducials: int = 20,
    ):
        super().__init__()
        self.use_tps = use_tps
        if use_tps:
            from .tps import TPSTransformer

            self.tps = TPSTransformer(tps_fiducials)
        out_ch = cnn_out_channels or (128 if cnn_stage_plan == "micro" else 512)
        self.enc_dropout_p = enc_dropout_p
        self.cnn = SEResNet31(out_ch, cnn_stage_plan, dropblock_p)
        self.enc_rnn1 = BiLSTM(out_ch, hidden_size, hidden_size)
        self.enc_rnn2 = BiLSTM(hidden_size, hidden_size, hidden_size)
        self.decoder = AttentionDecoder(
            hidden_size, hidden_size, num_classes, sos_id, eos_id, blank_id, dec_dropout_p
        )

    def cast(self, dtype: torch.dtype) -> "TRBAModel":
        for m in (self.cnn, self.enc_rnn1, self.enc_rnn2) + ((self.tps,) if self.use_tps else ()):
            m.to(dtype)
        return self

    def encode(
        self,
        x: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """x (B, H, W, 3) normalized → (B, W', hidden)."""
        if self.use_tps:
            x = self.tps(x)  # rectified onto a grid of the input's size
        f = self.cnn(x.permute(0, 3, 1, 2), generator).mean(dim=2)  # height pool
        f = self.enc_rnn2(self.enc_rnn1(f.transpose(1, 2)))
        if self.training and self.enc_dropout_p > 0:
            f = dropout(f, self.enc_dropout_p, generator)
        return f

    def forward(
        self,
        x: torch.Tensor,
        text_in: torch.Tensor,
        ss_prob: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Teacher-forced logits (B, steps, V); ``ss_prob`` > 0 turns on
        scheduled sampling in train mode."""
        enc = self.encode(x, generator)
        with _no_autocast(enc):
            return self.decoder(float32_or_wider(enc), text_in, ss_prob, generator)

    def greedy(self, x, max_len: int = 25):
        enc = self.encode(x)
        with _no_autocast(enc):
            return self.decoder.greedy(enc, max_len=max_len)

    def beam(self, x, max_len=25, beam_size=8, alpha=0.9, temperature=1.7):
        enc = self.encode(x)
        with _no_autocast(enc):
            return self.decoder.beam(enc, max_len, beam_size, alpha, temperature)
