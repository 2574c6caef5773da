"""One TRBA decode step (additive attention + LSTM cell): kernels and plain twin.

``attention_step`` is what ``models.attention.AttentionDecoder`` calls once per
decode step. The encoder memory ``enc`` (B, T, E) and ``proj_enc`` (B, T, H)
holds one row per word; the states ``h``, ``c`` and tokens ``tok`` hold
R = B·beam rows, and row r attends over word r // beam (``beam=1`` is the
greedy path). On CUDA tensors it launches the three grids of
``csrc/attention_step.cu`` (the counterpart of
``manuscript_tpu/ops/pallas_attention.py``): proj_h on the tensor cores, the
attention, then the gates on the tensor cores. On CPU tensors it runs ``attention_step_plain``, the
same function in torch ops. There is no other route: a tensor on any other
device, or a CUDA tensor the kernels do not take, raises. The kernels have no
backward pass: on the card, inputs that require grad under grad mode raise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

launches = 0  # decode steps run through the kernels, for proof of the route
kernel_launches = 0  # raw kernel launches: three per step (proj_h, attention, gates)
# a list while utils.profiling.count_flops runs: each kernel step's FLOPs
flop_calls = None
CLUSTER = 4  # blocks of the attention grid that share one word
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may have on Hopper


def _check_beam(enc, h, beam: int) -> None:
    if beam < 1:
        raise ValueError(f"attention_step: beam={beam} is below 1")
    rows = h.shape[0]
    if rows % beam:
        raise ValueError(f"attention_step: {rows} beam rows are not a multiple of beam={beam}")
    if rows // beam != enc.shape[0]:
        raise ValueError(
            f"attention_step: {rows} beam rows of beam={beam} need {rows // beam} "
            f"words of encoder memory, got {enc.shape[0]}"
        )


def attention_step_plain(
    enc, proj_enc, h, c, tok, w_h2h, b_h2h, w_score, w_ih, w_hh, bias, beam: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """enc (B,T,E), proj_enc (B,T,H), h/c (B·beam,H), tok (B·beam,) int;
    w_h2h (H,H), b_h2h (H,), w_score (H,) or (H,1), w_ih (E+V,4H), w_hh (H,4H),
    bias (4H,) → (h', c'). Row r attends over word r // beam; the token's
    input is the row ``w_ih[E + tok]``."""
    _check_beam(enc, h, beam)
    if beam > 1:
        enc = enc.repeat_interleave(beam, dim=0)
        proj_enc = proj_enc.repeat_interleave(beam, dim=0)
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


def step_cost(words: int, rows: int, t: int, hidden: int, e_dim: int, n_tok: int):
    """(FLOPs, bytes) of one decode step: ``rows`` beam rows over ``words``
    words of memory, T steps, H hidden, E features, ``n_tok`` distinct
    tokens. FLOPs per row: proj_h (2H²), the scores (3TH + 5T), the context
    (2TE), the gate products (8EH + 8H²) and the gates (16H). Bytes: each
    input read once (the words' memory, h, c, the tokens, W_h2h, b_h2h,
    w_score, W_ih[:E], the token rows used, W_hh, bias) and h', c' written,
    in float32."""
    flops = rows * (2 * hidden * hidden + 3 * t * hidden + 5 * t + 2 * t * e_dim
                    + 8 * e_dim * hidden + 8 * hidden * hidden + 16 * hidden)
    rest = (2 * rows * hidden + rows + hidden * hidden + 2 * hidden
            + (e_dim + n_tok + hidden) * 4 * hidden + 4 * hidden + 2 * rows * hidden)
    return flops, 4 * (words * t * (e_dim + hidden) + rest)


def _lib():
    lib = _build.library("attention_step")
    fn = lib.attention_step_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.attention_step_smem_bytes.restype = ctypes.c_int
        lib.attention_step_smem_bytes.argtypes = [ctypes.c_int] * 5
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
    if t.data_ptr() % 16:
        raise ValueError(f"attention_step: {name} is not 16-byte aligned")


def attention_step_cuda(
    enc, proj_enc, h, c, tok, w_h2h, b_h2h, w_score, w_ih, w_hh, bias, beam: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the step's three grids on the current stream. The launch goes
    through ctypes and records no autograd graph, so with grad mode on an
    input that requires grad raises rather than losing its gradient."""
    global launches, kernel_launches
    args = (enc, proj_enc, h, c, w_h2h, b_h2h, w_score, w_ih, w_hh, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError(
            "attention_step: the CUDA kernels have no backward pass; call them under "
            "torch.no_grad() (training's teacher-forced step runs "
            "AttentionDecoder.forward in torch ops)"
        )
    _check_beam(enc, h, beam)
    b, t, e_dim = enc.shape
    r, hidden = h.shape
    _require(enc, "enc", (b, t, e_dim))
    _require(proj_enc, "proj_enc", (b, t, hidden))
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
    if hidden % 64 or e_dim % (4 * CLUSTER) or max(hidden, e_dim) > 256 * CLUSTER:
        raise ValueError(
            f"attention_step: H={hidden} must be a multiple of 64, E={e_dim} one "
            f"of {4 * CLUSTER}, and both at most {256 * CLUSTER}"
        )
    lib = _lib()
    if lib.attention_step_smem_bytes(beam, t, hidden, e_dim, CLUSTER) > SMEM_LIMIT:
        raise ValueError(
            f"attention_step: beam={beam}, T={t}, H={hidden}, E={e_dim} need more "
            f"than {SMEM_LIMIT} bytes of shared memory per block"
        )
    proj_h = torch.empty_like(h)
    ctx = torch.empty(r, e_dim, dtype=torch.float32, device=h.device)
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    stream = torch.cuda.current_stream(enc.device).cuda_stream
    status = lib.attention_step_launch(
        enc.data_ptr(), proj_enc.data_ptr(), h.data_ptr(), c.data_ptr(),
        tok.data_ptr(), w_h2h.data_ptr(), b_h2h.data_ptr(), w_score.data_ptr(),
        w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), proj_h.data_ptr(), ctx.data_ptr(),
        h_out.data_ptr(), c_out.data_ptr(), b, beam, t, hidden, e_dim, CLUSTER, stream,
    )
    _build.check(status, "attention_step")
    launches += 1
    if flop_calls is not None:
        flop_calls.append(step_cost(b, r, t, hidden, e_dim, 0)[0])
    kernel_launches += 3
    return h_out, c_out


def attention_step(
    enc, proj_enc, h, c, tok, w_h2h, b_h2h, w_score, w_ih, w_hh, bias, beam: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch ops for CPU tensors, the CUDA kernels otherwise."""
    if enc.device.type == "cpu":
        return attention_step_plain(
            enc, proj_enc, h, c, tok, w_h2h, b_h2h, w_score, w_ih, w_hh, bias, beam
        )
    return attention_step_cuda(
        enc, proj_enc, h, c, tok, w_h2h, b_h2h, w_score, w_ih, w_hh, bias, beam
    )
