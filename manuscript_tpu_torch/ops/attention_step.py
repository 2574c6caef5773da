"""One TRBA decode step (additive attention + LSTM cell): kernel and plain twin.

``attention_step`` is what ``models.attention.AttentionDecoder`` calls once per
decode step. On CUDA tensors it launches ``csrc/attention_step.cu`` (the
counterpart of ``manuscript_tpu/ops/pallas_attention.py``); on CPU tensors it
runs ``attention_step_plain``, the same function in torch ops. There is no
other route: a tensor on any other device, or a CUDA tensor the kernel does
not take, raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

launches = 0  # kernel launches, for proof that a run went through the kernel


def attention_step_plain(
    enc, proj_enc, h, c, tok, w_h2h, b_h2h, w_score, w_ih, w_hh, bias
) -> Tuple[torch.Tensor, torch.Tensor]:
    """enc (R,T,E), proj_enc (R,T,H), h/c (R,H), tok (R,) int; w_h2h (H,H),
    b_h2h (H,), w_score (H,) or (H,1), w_ih (E+V,4H), w_hh (H,4H),
    bias (4H,) → (h', c'). The token's input is the row ``w_ih[E + tok]``."""
    e_dim = enc.shape[-1]
    hidden = h.shape[-1]
    proj_h = h @ w_h2h + b_h2h
    e = torch.tanh(proj_enc + proj_h[:, None, :]) @ w_score.reshape(-1, 1)
    alpha = torch.softmax(e, dim=1)  # (R, T, 1)
    ctx = torch.sum(alpha * enc, dim=1)
    z = ctx @ w_ih[:e_dim] + w_ih[e_dim + tok.long()] + h @ w_hh + bias
    i = torch.sigmoid(z[:, :hidden])
    f = torch.sigmoid(z[:, hidden : 2 * hidden])
    g = torch.tanh(z[:, 2 * hidden : 3 * hidden])
    o = torch.sigmoid(z[:, 3 * hidden :])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def _lib():
    lib = _build.library("attention_step")
    fn = lib.attention_step_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.attention_step_smem_bytes.restype = ctypes.c_int
        lib.attention_step_smem_bytes.argtypes = [ctypes.c_int] * 4
    return lib


def _require(t: torch.Tensor, name: str, shape, dtype=torch.float32):
    if t.device.type != "cuda":
        raise ValueError(f"attention_step: {name} is on {t.device}, not CUDA")
    if t.dtype != dtype:
        raise TypeError(f"attention_step: {name} is {t.dtype}, needs {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"attention_step: {name} has shape {tuple(t.shape)}, needs {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"attention_step: {name} is not contiguous")


def attention_step_cuda(
    enc, proj_enc, h, c, tok, w_h2h, b_h2h, w_score, w_ih, w_hh, bias
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the fused step kernel on the current stream."""
    global launches
    r, t, e_dim = enc.shape
    hidden = h.shape[-1]
    _require(enc, "enc", (r, t, e_dim))
    _require(proj_enc, "proj_enc", (r, t, hidden))
    _require(h, "h", (r, hidden))
    _require(c, "c", (r, hidden))
    _require(tok, "tok", (r,), torch.int32)
    _require(w_h2h, "w_h2h", (hidden, hidden))
    _require(b_h2h, "b_h2h", (hidden,))
    _require(w_score, "w_score", (hidden,))
    if w_ih.dim() != 2 or w_ih.shape[0] <= e_dim:
        raise ValueError(f"attention_step: w_ih has shape {tuple(w_ih.shape)}")
    _require(w_ih, "w_ih", (w_ih.shape[0], 4 * hidden))
    _require(w_hh, "w_hh", (hidden, 4 * hidden))
    _require(bias, "bias", (4 * hidden,))
    if hidden % 4 or e_dim % 4:
        raise ValueError(f"attention_step: H={hidden} and E={e_dim} must be multiples of 4")
    lib = _lib()
    if lib.attention_step_smem_bytes(r, t, hidden, e_dim) > 48 * 1024:
        raise ValueError(
            f"attention_step: T={t}, H={hidden}, E={e_dim} need more than "
            "48 KB of shared memory per block"
        )
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    stream = torch.cuda.current_stream(enc.device).cuda_stream
    status = lib.attention_step_launch(
        enc.data_ptr(), proj_enc.data_ptr(), h.data_ptr(), c.data_ptr(),
        tok.data_ptr(), w_h2h.data_ptr(), b_h2h.data_ptr(), w_score.data_ptr(),
        w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), h_out.data_ptr(),
        c_out.data_ptr(), r, t, hidden, e_dim, stream,
    )
    _build.check(status, "attention_step")
    launches += 1
    return h_out, c_out


def attention_step(
    enc, proj_enc, h, c, tok, w_h2h, b_h2h, w_score, w_ih, w_hh, bias
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch ops for CPU tensors, the CUDA kernel otherwise."""
    if enc.device.type == "cpu":
        return attention_step_plain(
            enc, proj_enc, h, c, tok, w_h2h, b_h2h, w_score, w_ih, w_hh, bias
        )
    return attention_step_cuda(
        enc, proj_enc, h, c, tok, w_h2h, b_h2h, w_score, w_ih, w_hh, bias
    )
