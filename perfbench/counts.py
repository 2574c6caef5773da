"""The benchmark's own operation and byte counts, and the card's peaks.

These are copies, kept here so that a change to the program cannot move the
yardstick it is measured by:

* ``k1_step_cost`` is ``step_cost`` of ``manuscript_tpu_torch/ops/attention_step.py``
  (K1, one decode step of the attention LSTM), with the token rows read
  counted as the rows the step can read, min(rows, vocabulary);
* ``bound_ms`` is ``bound_ms`` of ``manuscript_tpu_torch/utils/profiling.py``;
* the peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity);
* ``trba_call_flops`` and ``east_train_step_flops`` walk the networks'
  shapes: the SEResNet31 stage plans of ``models/seresnet31.py``, the
  ResNet stage blocks of ``models/resnet.py``, the merge decoder of
  ``models/east.py``.

FLOPs count two per multiply-add of the convolutions and matrix products
(as ``torch.utils.flop_counter`` counts them), plus K1's own count of its
step, which includes its few elementwise operations.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM, dense TF32 on the tensor cores

SERESNET31_PLANS = {  # (planes, blocks, stride) per stage
    "full": ((256, 1, 2), (256, 2, 1), (512, 5, 2), (512, 3, 1)),
    "tiny": ((256, 1, 2), (256, 1, 1), (512, 1, 2), (512, 1, 1)),
    "micro": ((64, 1, 2), (64, 1, 1), (128, 1, 2), (128, 1, 1)),
}
SERESNET31_STEM = {"micro": (32, 64)}  # default (64, 128)
RESNET_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
                 "resnet50-micro": (1, 1, 1, 1)}
RESNET_STEM = {"resnet50-micro": 16}  # default 64


def bound_ms(nbytes: float, flops: float) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the float32 operations over the float32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k1_step_cost(words: int, rows: int, t: int, hidden: int, e_dim: int,
                 n_tok: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one K1 decode step: ``rows`` beam rows over ``words``
    words of encoder memory of ``t`` positions, ``hidden`` H, ``e_dim`` E,
    ``n_tok`` token rows of W_ih read. FLOPs per row: proj_h (2H²), the
    scores (3TH + 5T), the context (2TE), the gate products (8EH + 8H²) and
    the gates (16H). Bytes: each input read once and h', c' written, float32."""
    flops = rows * (2 * hidden * hidden + 3 * t * hidden + 5 * t + 2 * t * e_dim
                    + 8 * e_dim * hidden + 8 * hidden * hidden + 16 * hidden)
    rest = (2 * rows * hidden + rows + hidden * hidden + 2 * hidden
            + (e_dim + n_tok + hidden) * 4 * hidden + 4 * hidden + 2 * rows * hidden)
    return flops, 4 * (words * t * (e_dim + hidden) + rest)


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def conv_flops(cin: int, cout: int, k: Tuple[int, int], ho: int, wo: int) -> int:
    return 2 * cin * cout * k[0] * k[1] * ho * wo


def seresnet31_convs(h: int, w: int, plan: str, out_channels: int):
    """[(FLOPs a sample, name)] of SEResNet31's convolutions and SE products
    at an (h, w) input → (list, (h', w', channels) of the output)."""
    s1, s2 = SERESNET31_STEM.get(plan, (64, 128))
    ops: List[Tuple[int, str]] = [(conv_flops(3, s1, (3, 3), h, w), "stem_conv1"),
                                  (conv_flops(s1, s2, (3, 3), h, w), "stem_conv2")]
    h, w, cin = h // 2, w // 2, s2
    for planes, blocks, stride in SERESNET31_PLANS[plan]:
        for b in range(blocks):
            st = stride if b == 0 else 1
            ho, wo = _out(h, 3, st, 1), _out(w, 3, st, 1)
            ops.append((conv_flops(cin, planes, (3, 3), ho, wo), "conv1"))
            ops.append((conv_flops(planes, planes, (3, 3), ho, wo), "conv2"))
            ops.append((2 * 2 * planes * (planes // 16), "se"))
            if b == 0 and (st != 1 or cin != planes):
                ops.append((conv_flops(cin, planes, (1, 1), ho, wo), "down_conv"))
            h, w, cin = ho, wo, planes
    h, w = _out(h, 2, 2, 0), _out(w, 2, 1, 1)
    ops.append((conv_flops(cin, out_channels, (2, 2), h, w), "out_conv1"))
    h, w = _out(h, 2, 1, 0), _out(w, 2, 1, 0)
    ops.append((conv_flops(out_channels, out_channels, (2, 2), h, w), "out_conv2"))
    return ops, (h, w, out_channels)


def trba_encode_flops(img_h: int, img_w: int, plan: str, out_channels: int,
                      hidden: int) -> Tuple[int, int]:
    """(FLOPs a word of the encoder and the decoder's memory projection,
    encoder positions T)."""
    ops, (_, t, c) = seresnet31_convs(img_h, img_w, plan, out_channels)
    flops = sum(f for f, _ in ops)
    for i in (c, hidden):  # two BiLSTMs: input projection, recurrence, output projection
        flops += 2 * (2 * t * i * 4 * hidden + 2 * t * hidden * 4 * hidden)
        flops += 2 * t * 2 * hidden * hidden
    flops += 2 * t * hidden * hidden  # the decoder's i2h over the memory
    return flops, t


def trba_call_flops(words: int, cfg: Dict) -> int:
    """FLOPs of one recognition call of ``words`` strips at the
    configuration's shapes: the encoder, and ``max_length`` beam steps of K1
    and the output projection over words × beam rows."""
    hidden, vocab = cfg["hidden_size"], cfg["num_classes"]
    enc, t = trba_encode_flops(cfg["img_h"], cfg["img_w"], cfg["cnn_stage_plan"],
                               cfg["cnn_out_channels"], hidden)
    rows = words * cfg["beam_size"]
    step, _ = k1_step_cost(words, rows, t, hidden, hidden, min(rows, vocab))
    return words * enc + cfg["max_length"] * (step + 2 * rows * hidden * vocab)


def east_forward_convs(side: int, backbone: str) -> List[Tuple[int, str]]:
    """[(FLOPs a sample, name)] of EAST's convolutions at a square input."""
    width = RESNET_STEM.get(backbone, 64)
    h = _out(side, 7, 2, 3)
    ops = [(conv_flops(3, width, (7, 7), h, h), "stem")]
    h = _out(h, 3, 2, 1)
    cin, planes, feats = width, width, []
    for stage, n_blocks in enumerate(RESNET_BLOCKS[backbone]):
        for b in range(n_blocks):
            st = (1 if stage == 0 else 2) if b == 0 else 1
            ho = _out(h, 3, st, 1)
            ops.append((conv_flops(cin, planes, (1, 1), h, h), "conv1"))
            ops.append((conv_flops(planes, planes, (3, 3), ho, ho), "conv2"))
            ops.append((conv_flops(planes, 4 * planes, (1, 1), ho, ho), "conv3"))
            if b == 0:
                ops.append((conv_flops(cin, 4 * planes, (1, 1), ho, ho), "down_conv"))
            h, cin = ho, 4 * planes
        feats.append((h, cin))
        planes *= 2
    mult = 0.25 if backbone.endswith("-micro") else 1.0
    c = lambda n: max(8, int(n * mult))
    plan = ((c(512), c(512)), (c(256), c(256)), (c(128), c(128)), (c(64), c(32)))
    prev = 0
    for (hs, ch), (mid, out) in zip(reversed(feats), plan):
        ops.append((conv_flops(prev + ch, mid, (1, 1), hs, hs), "dec_conv1x1"))
        ops.append((conv_flops(mid, out, (3, 3), hs, hs), "dec_conv3x3"))
        prev = out
    h4 = feats[0][0]
    ops.append((conv_flops(prev, 1, (1, 1), h4, h4), "score_head"))
    ops.append((conv_flops(prev, 8, (1, 1), h4, h4), "geo_head"))
    return ops


def east_train_step_flops(side: int, batch: int, backbone: str, passes: int = 2) -> int:
    """FLOPs of one training step: ``passes`` forward and backward passes
    (two under SAM/ASAM) of ``batch`` images at ``side``². A convolution's
    backward is its input gradient and its weight gradient, each as many
    FLOPs as its forward; the stem's input needs no gradient."""
    ops = east_forward_convs(side, backbone)
    fwd = sum(f for f, _ in ops)
    stem = ops[0][0]
    return passes * batch * (3 * fwd - stem)


def percent(num: float, den: float) -> float:
    return 100.0 * num / den
