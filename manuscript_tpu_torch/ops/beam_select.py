"""The beam's advance (K8): the kernels of ``csrc/beam_select.cu`` and their
plain version.

``beam_select(logits, scores, finished, rows, eos_id, temperature, lp)``
takes one step's raw logits (B·k, V) and the state of (B, k) beams (their
scores, float32, and whether each has finished) and returns the k beams
each line keeps: (parent, token, score, finished), each (B, k). It scales
the logits by 1/T (T at least 1e-6), takes each row's log-softmax, lets a
finished beam continue only with EOS at log-prob 0 (every other token at
-1e30), adds the beam's score, divides by the GNMT length scale ``lp``
(``models/beam.length_scale``; None: no scaling, as at α = 0), and keeps
the k best of each line's k·V scores, in descending order with ties to the
lowest flat index (``topk_lowest_index``, ``jax.lax.top_k``'s rule).
Parent and token are the flat index's quotient and remainder by V, the
score is the kept value times ``lp``, and a kept beam has finished if its
parent had or its token is EOS.

On a card it launches the kernels: a log-sum-exp a row, then the
selection, or the selection alone where a line's k·V values fit one block
(``plan``); ``launches`` counts them. They take float32 logits, a
contiguous (B·k, V) matrix, up to ``KMAX`` beams a line; anything else on a
card raises ``ValueError``. On the CPU the same arithmetic runs as the
composed torch ops it replaced (``select_plain``), which the CPU tests hold
bit for bit to the beam's earlier inline loop. ``rows`` is
``arange(B)[:, None]`` on the logits' device, which the plain version
gathers with.

The kernels' selection merges each block's K best (K, the power of two at
or above k) in a fixed order; the last block of a line, found with a
ticket counter that the card keeps, merges the blocks' candidates. The
counters wrap back to 0 at the end of each launch; each stream has its own
array, so launches on two streams of one card may run at once.
"""

from __future__ import annotations

import ctypes
from contextlib import nullcontext
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30  # a finished beam's log-prob of every token but EOS
THREADS = 256  # a block's threads (BS_THREADS)
KMAX = 16  # the most beams a line (BS_KMAX)
LINE_VALUES = 8192  # a line of at most this many values takes one block: one launch
CHUNK_MIN = 2048  # values a block at least, where a line takes several blocks
WAVE = 4  # blocks an SM that the chunks of a launch aim for

launches = 0  # kernel launches made


def topk_lowest_index(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, ties to the lowest index (as
    ``jax.lax.top_k``; ``torch.topk`` on CUDA does not promise that)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---- the plain version: the composed ops the kernels replace ----

def next_scores_plain(logits: torch.Tensor, scores: torch.Tensor, finished: torch.Tensor,
                      eos_id: int, temperature: float, lp: Optional[float]) -> torch.Tensor:
    """Every candidate's score (B, k·V) in torch ops, the values the top-k
    keeps the k best of."""
    b, k = scores.shape
    v = logits.shape[-1]
    logits = logits / max(temperature, 1e-6)
    log_probs = torch.log_softmax(logits, dim=-1).reshape(b, k, v)
    # finished beams: only EOS continues, at log-prob 0
    log_probs = torch.where(finished[:, :, None], torch.full_like(log_probs, NEG_INF), log_probs)
    log_probs[..., eos_id] = torch.where(finished, torch.zeros_like(scores),
                                         log_probs[..., eos_id])
    next_scores = scores[:, :, None] + log_probs
    if lp is not None:
        next_scores = next_scores / lp
    return next_scores.reshape(b, k * v)


def select_plain(logits: torch.Tensor, scores: torch.Tensor, finished: torch.Tensor,
                 rows: torch.Tensor, eos_id: int, temperature: float, lp: Optional[float]):
    """The advance in torch ops → (parent, token, score, finished), each (B, k)."""
    k, v = scores.shape[1], logits.shape[-1]
    top_scores, top_idx = topk_lowest_index(
        next_scores_plain(logits, scores, finished, eos_id, temperature, lp), k)
    parent = top_idx // v
    tok = top_idx % v
    finished = finished[rows, parent] | (tok == eos_id)
    return parent, tok, top_scores * lp if lp is not None else top_scores, finished


# ---- the plan and the cost ----

class Plan(NamedTuple):
    """How a launch cuts (B·k, V): ``two`` passes (a log-sum-exp launch
    first) or one, ``chunk`` values a block and ``chunks`` blocks a line."""

    two: bool
    chunk: int
    chunks: int


def width(k: int) -> int:
    """K: the kernels' candidates a thread and a block, the power of two at
    or above k."""
    return 1 << (k - 1).bit_length()


def plan(lines: int, k: int, v: int, sms: int) -> Plan:
    """A line of at most ``LINE_VALUES`` values is one block's, which
    computes its rows' log-sum-exp itself; a longer line is cut into chunks
    of at least ``CHUNK_MIN`` values, enough for ``WAVE`` blocks on each of
    ``sms`` SMs, each chunk a multiple of 4 values."""
    kv = k * v
    if kv <= LINE_VALUES:
        return Plan(False, kv, 1)
    chunks = max(1, min(-(-WAVE * sms // lines), kv // CHUNK_MIN))
    chunk = -(-kv // chunks)
    chunk = -(-chunk // 4) * 4
    return Plan(True, chunk, -(-kv // chunk))


def cost(lines: int, k: int, v: int) -> Tuple[int, int]:
    """(f32 operations, bytes) of one advance: the logits, scores and
    finished flags read once and the four outputs written once (the kernels
    read the logits twice). Operations a logit: the 1/T scale, the max, the
    exponential and its sum, the two subtractions of the log-softmax, the
    score's add, the length scale and the compare that keeps it or not."""
    beams = lines * k
    return 9 * beams * v, 4 * beams * v + beams * (4 + 1) + beams * (8 + 8 + 4 + 1)


# ---- the kernels ----

def _lib():
    lib = _build.library("beam_select")
    if lib.beam_select_top.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        for name, args in (
            ("beam_select_lse", [p, p, ll, i, f, p, p]),
            ("beam_select_top", [p, p, p, p, ll, i, i, i, f, f, i, ll, i, p, p, p, p, p, p]),
        ):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = ctypes.c_int, args
        for name in ("beam_select_threads", "beam_select_kmax"):
            getattr(lib, name).restype = ctypes.c_int
        if (lib.beam_select_threads(), lib.beam_select_kmax()) != (THREADS, KMAX):
            raise RuntimeError("beam_select: csrc/beam_select.cu and its wrapper disagree on "
                               "THREADS or KMAX")
    return lib


# per device and shape, found once: the host's work a step is most of a
# small beam's time
_plans: Dict[tuple, Plan] = {}  # (device, lines, k, V) → plan
_tickets: Dict[tuple, Tuple[torch.Tensor, int]] = {}  # (device, stream) → (counters, address)


def _plan(dev: torch.device, lines: int, k: int, v: int) -> Plan:
    key = (dev.index, lines, k, v)
    pl = _plans.get(key)
    if pl is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        pl = _plans[key] = plan(lines, k, v, sms)
    return pl


def _tickets_of(dev: torch.device, stream: int, lines: int) -> int:
    """The address of at least ``lines`` ticket counters of ``stream`` on
    ``dev``, zero between launches: launches on one stream run one after
    another, so they never hold a counter at once. A longer array replaces
    a shorter one in the stream's order."""
    t = _tickets.get((dev.index, stream))
    if t is None or t[0].numel() < lines:
        counters = torch.zeros(1 << (lines - 1).bit_length(), dtype=torch.int32, device=dev)
        t = _tickets[dev.index, stream] = (counters, counters.data_ptr())
    return t[1]


def _on(dev: torch.device):
    """The device's context, entered only when another device is current."""
    return nullcontext() if torch.cuda.current_device() == dev.index else torch.cuda.device(dev)


def _launch(status: int, what: str) -> None:
    global launches
    _build.check(status, f"beam_select {what}")
    launches += 1


def _checked(logits: torch.Tensor, scores: torch.Tensor, finished: torch.Tensor, eos_id: int):
    """(B, k, V), or ``ValueError`` for what the kernels do not take."""
    if logits.dtype != torch.float32 or logits.dim() != 2 or not logits.is_contiguous():
        raise ValueError(f"beam_select: the logits must be a contiguous (B·k, V) float32 matrix; "
                         f"got {tuple(logits.shape)} {logits.dtype}, strides {logits.stride()}")
    if scores.dim() != 2:
        raise ValueError(f"beam_select: scores of shape {tuple(scores.shape)}; want (B, k)")
    (b, k), v = scores.shape, logits.shape[1]
    if not 1 <= k <= KMAX:
        raise ValueError(f"beam_select: {k} beams a line; the kernels take 1 to {KMAX}")
    if logits.shape[0] != b * k or v < 1 or k * v >= 2**32 - 1:
        raise ValueError(f"beam_select: logits of shape {tuple(logits.shape)} for {b} × {k} "
                         "beams (k·V below 2^32 - 1)")
    for name, t, dtype in (("scores", scores, torch.float32), ("finished", finished, torch.bool)):
        if (t.dtype != dtype or t.shape != (b, k) or not t.is_contiguous()
                or t.device != logits.device):
            raise ValueError(f"beam_select: {name} must be a contiguous ({b}, {k}) {dtype} tensor "
                             f"on {logits.device}; got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not 0 <= eos_id < v:
        raise ValueError(f"beam_select: EOS {eos_id} outside the vocabulary of {v}")
    return b, k, v


def select_cuda(logits: torch.Tensor, scores: torch.Tensor, finished: torch.Tensor, eos_id: int,
                temperature: float, lp: Optional[float]):
    """``select_plain`` in one or two launches on the current stream."""
    b, k, v = _checked(logits, scores, finished, eos_id)
    dev = logits.device
    two, chunk, chunks = _plan(dev, b, k, v)
    K = width(k)
    ids = torch.empty((2, b, k), dtype=torch.int64, device=dev)  # tokens, then parents
    out_scores = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_finished = torch.empty((b, k), dtype=torch.bool, device=dev)
    cand_bytes = 8 * b * chunks * K if chunks > 1 else 0
    scratch = (torch.empty(cand_bytes + (8 * b * k if two else 0), dtype=torch.uint8, device=dev)
               if cand_bytes or two else None)
    at = scratch.data_ptr() if scratch is not None else None
    t, scale = ctypes.c_float(max(temperature, 1e-6)), ctypes.c_float(1.0 if lp is None else lp)
    lib = _lib()
    with _on(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lse = at + cand_bytes if two else None
        if two:
            _launch(lib.beam_select_lse(logits.data_ptr(), finished.data_ptr(), b * k, v, t, lse,
                                        stream), "log-sum-exp")
        _launch(lib.beam_select_top(
            logits.data_ptr(), lse, scores.data_ptr(), finished.data_ptr(), b, k, v, eos_id, t,
            scale, K, chunk, chunks, at if cand_bytes else None,
            _tickets_of(dev, stream, b) if chunks > 1 else None, ids.data_ptr(),
            out_scores.data_ptr(), out_finished.data_ptr(), stream), "selection")
    return ids[1], ids[0], out_scores, out_finished


# ---- the route ----

def beam_select(logits: torch.Tensor, scores: torch.Tensor, finished: torch.Tensor,
                rows: torch.Tensor, eos_id: int, temperature: float, lp: Optional[float]):
    """One step of the beam → (parent, token, score, finished) of the kept
    beams, each (B, k): the kernels for logits on a card, the plain version
    for logits on the CPU."""
    if logits.device.type == "cuda":
        return select_cuda(logits, scores, finished, eos_id, temperature, lp)
    if logits.device.type != "cpu":
        raise ValueError(f"beam_select: logits on {logits.device}; the kernels run on a CUDA card")
    return select_plain(logits, scores, finished, rows, eos_id, temperature, lp)
