"""The benchmark's own operation and byte counts of TrOCR (``models/trocr.py``
of the port, ``reference/trocr.py`` here), from the configuration's widths.

FLOPs count two per multiply-add of the convolutions and matrix products
(as ``torch.utils.flop_counter`` counts them), attention's two products
included; softmax, LayerNorm, GELU and the beam's bookkeeping are left out.
A decode step's least bytes: the decoder weights it reads once (every
layer's self-attention, cross-attention query and output, MLP and
LayerNorms, the token embedding as the tied output projection), each
line's cross-attention keys and values once, every row's self-attention
keys and values up to the step and its new ones written, and the logits
written and read once; float32 throughout.
"""

from __future__ import annotations

from typing import Dict, Tuple

from perfbench.counts import bound_ms

F32 = 4


def _widths(cfg: Dict):
    e, d = cfg["encoder"], cfg["decoder"]
    return e, d, (e["image_size"] // e["patch_size"]) ** 2 + 1


def encode_flops(cfg: Dict) -> int:
    """FLOPs of the encoder on one line."""
    e, _, t = _widths(cfg)
    h, p = e["hidden_size"], e["patch_size"]
    patch = 2 * (t - 1) * e["num_channels"] * p * p * h
    layer = 2 * t * h * (4 * h + 2 * e["intermediate_size"]) + 4 * t * t * h
    return patch + e["num_hidden_layers"] * layer


def cross_kv_flops(cfg: Dict) -> int:
    """FLOPs of every layer's cross-attention keys and values of one line."""
    _, d, t = _widths(cfg)
    return d["decoder_layers"] * 2 * 2 * t * d["cross_attention_hidden_size"] * d["d_model"]


def step_flops(cfg: Dict, rows: int, t: int) -> int:
    """FLOPs of decode step ``t`` (0-based) over ``rows`` beam rows: each
    layer's self-attention projections (4) and its products over t + 1
    positions, the cross-attention's query and output projections and its
    products over the encoder's tokens, the MLP; the output projection."""
    _, d, s = _widths(cfg)
    m, f = d["d_model"], d["decoder_ffn_dim"]
    layer = 2 * 6 * m * m + 2 * 2 * m * f + 2 * 2 * m * (t + 1) + 2 * 2 * m * s
    return rows * (d["decoder_layers"] * layer + 2 * m * d["vocab_size"])


def step_weight_bytes(cfg: Dict) -> int:
    """Bytes of the decoder weights one step reads."""
    _, d, _ = _widths(cfg)
    m, f = d["d_model"], d["decoder_ffn_dim"]
    layer = 6 * (m * m + m) + (m * f + f) + (f * m + m) + 3 * 2 * m
    return F32 * (d["decoder_layers"] * layer + d["vocab_size"] * m + 2 * m)


def step_bytes(cfg: Dict, lines: int, rows: int, t: int) -> int:
    """Least bytes of decode step ``t`` over ``lines`` lines and ``rows`` rows."""
    _, d, s = _widths(cfg)
    m, n = d["d_model"], d["decoder_layers"]
    cross = lines * n * 2 * s * m
    self_kv = rows * n * 2 * (t + 1) * m
    logits = 2 * rows * d["vocab_size"]
    return step_weight_bytes(cfg) + F32 * (cross + self_kv + logits)


def call_flops(lines: int, cfg: Dict) -> int:
    """FLOPs of one beam call on ``lines`` lines: the encoder, the cross
    keys and values, and ``max_length`` steps over lines × beam rows."""
    rows = lines * cfg["beam_size"]
    return (lines * (encode_flops(cfg) + cross_kv_flops(cfg))
            + sum(step_flops(cfg, rows, t) for t in range(cfg["max_length"])))


def steps_least_ms(cfg: Dict, lines: int) -> Tuple[float, int]:
    """(the least ms of one call's ``max_length`` steps, the step count):
    each step's larger of its FLOPs over the float32 peak and its bytes over
    the memory rate, summed."""
    rows = lines * cfg["beam_size"]
    total = sum(bound_ms(step_bytes(cfg, lines, rows, t), step_flops(cfg, rows, t))[0]
                for t in range(cfg["max_length"]))
    return total, cfg["max_length"]
