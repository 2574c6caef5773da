"""The benchmark's own FLOP count of a TRBA training step
(``train/trba_train.train_step`` of the port, ``reference/trba_train.py``
here), from the configuration's shapes.

The forward: ``counts.trba_encode_flops`` (SEResNet31's convolutions, the
two BiLSTMs, the decoder's memory projection) and, at each of the
``max_length`` + 1 teacher-forced steps, K1's count of one attention and
LSTM step (``counts.k1_step_cost``, one word a row) and the output
projection. A step is the forward and its backward, the backward twice the
forward's FLOPs (an input and a weight gradient of every product) less the
stem's input gradient, which nothing needs. FLOPs count two per
multiply-add."""

from __future__ import annotations

from typing import Dict

from perfbench import counts


def train_step_flops(batch: int, cfg: Dict) -> int:
    hidden, vocab = cfg["hidden_size"], cfg["num_classes"]
    enc, t = counts.trba_encode_flops(cfg["img_h"], cfg["img_w"], cfg["cnn_stage_plan"],
                                      cfg["cnn_out_channels"], hidden)
    step, _ = counts.k1_step_cost(1, 1, t, hidden, hidden, 1)
    forward = enc + (cfg["max_length"] + 1) * (step + 2 * hidden * vocab)
    stem, _ = counts.seresnet31_convs(cfg["img_h"], cfg["img_w"], cfg["cnn_stage_plan"],
                                      cfg["cnn_out_channels"])[0][0]
    return batch * (3 * forward - stem)
