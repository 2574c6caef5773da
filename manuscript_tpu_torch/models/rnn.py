"""Bidirectional LSTM with an output projection (counterpart of
``manuscript_tpu/models/rnn.py``), in explicit torch ops.

Parameters keep the flax names and layout: ``fwd_kernel_ih`` (I, 4H),
``fwd_kernel_hh`` (H, 4H), ``fwd_bias`` (4H,) with gates i, f, g, o and the
input and hidden biases folded into one; the same for ``bwd_*``; ``proj`` is
a Linear(2H → out). The input projection of all timesteps is one matmul and
only the (B, 4H) recurrent product runs inside the time loop.
"""

from __future__ import annotations

import torch
from torch import nn


def lstm_cell_step(kernel_hh, x_proj, h, c):
    """One LSTM step given the precomputed input projection (B, 4H)."""
    hidden = h.shape[-1]
    z = x_proj + h @ kernel_hh
    i = torch.sigmoid(z[:, :hidden])
    f = torch.sigmoid(z[:, hidden : 2 * hidden])
    g = torch.tanh(z[:, 2 * hidden : 3 * hidden])
    o = torch.sigmoid(z[:, 3 * hidden :])
    c = f * c + i * g
    return o * torch.tanh(c), c


def lstm_scan(kernel_ih, kernel_hh, bias, x, reverse: bool = False):
    """Unidirectional LSTM over (B, T, I) → (B, T, H), in ``x``'s dtype."""
    b, t, _ = x.shape
    kernel_ih, kernel_hh, bias = (p.to(x.dtype) for p in (kernel_ih, kernel_hh, bias))
    hidden = kernel_hh.shape[0]
    x_proj = (x.reshape(b * t, -1) @ kernel_ih + bias).reshape(b, t, -1)
    h = x.new_zeros(b, hidden)
    c = x.new_zeros(b, hidden)
    out = [None] * t
    for s in (range(t - 1, -1, -1) if reverse else range(t)):
        h, c = lstm_cell_step(kernel_hh, x_proj[:, s], h, c)
        out[s] = h
    return torch.stack(out, dim=1)


class BiLSTM(nn.Module):
    def __init__(self, in_dim: int, hidden_size: int, output_size: int):
        super().__init__()
        h4 = 4 * hidden_size
        for d in ("fwd", "bwd"):
            self.register_parameter(f"{d}_kernel_ih", nn.Parameter(torch.empty(in_dim, h4)))
            self.register_parameter(f"{d}_kernel_hh", nn.Parameter(torch.empty(hidden_size, h4)))
            self.register_parameter(f"{d}_bias", nn.Parameter(torch.zeros(h4)))
        self.proj = nn.Linear(2 * hidden_size, output_size)

    def forward(self, x):  # (B, T, I) → (B, T, out)
        fwd = lstm_scan(self.fwd_kernel_ih, self.fwd_kernel_hh, self.fwd_bias, x)
        bwd = lstm_scan(self.bwd_kernel_ih, self.bwd_kernel_hh, self.bwd_bias, x, True)
        return self.proj(torch.cat([fwd, bwd], dim=-1))
