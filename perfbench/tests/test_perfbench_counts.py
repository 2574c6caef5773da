"""The benchmark's FLOP and byte counts against hand counts and against
torch's FLOP counter on the plain references, at small shapes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts
from perfbench.reference import east as east_ref
from perfbench.reference import trba as trba_ref
from perfbench.weights import make_weights


def test_k1_step_cost_by_hand():
    # 2 words, 6 rows, T 3, H 4, E 8, 5 token rows
    flops, nbytes = counts.k1_step_cost(2, 6, 3, 4, 8, 5)
    per_row = 2 * 16 + 3 * 3 * 4 + 5 * 3 + 2 * 3 * 8 + 8 * 8 * 4 + 8 * 16 + 16 * 4
    assert flops == 6 * per_row
    words = 2 * 3 * (8 + 4)
    rest = 2 * 6 * 4 + 6 + 16 + 2 * 4 + (8 + 5 + 4) * 16 + 16 + 2 * 6 * 4
    assert nbytes == 4 * (words + rest)


def test_k1_bound_at_the_cells_rows_is_its_operations():
    flops, nbytes = counts.k1_step_cost(512, 4096, 32, 256, 256, 194)
    ms, what = counts.bound_ms(nbytes, flops)
    assert what == "operations"
    assert ms == pytest.approx(flops / 67e12 * 1e3)
    assert ms == pytest.approx(0.07488, rel=1e-3)


def test_conv_output_sizes_and_flops_by_hand():
    ops, (h, w, c) = counts.seresnet31_convs(32, 128, "micro", 128)
    assert ops[0] == (2 * 3 * 32 * 9 * 32 * 128, "stem_conv1")
    assert (h, w, c) == (1, 16, 128)


def test_the_recognizer_encoder_count_equals_torchs_counter():
    cfg = {"cnn_stage_plan": "micro", "cnn_out_channels": 128, "hidden_size": 64, "num_classes": 194,
           "img_h": 32, "img_w": 128}
    w = make_weights(trba_ref.layout(cfg), 0, "cpu")
    x = torch.randint(0, 256, (2, 32, 128, 3), dtype=torch.uint8)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        enc = trba_ref.encode(w, cfg, x)
        enc @ w["decoder.i2h_kernel"]
    want, t = counts.trba_encode_flops(32, 128, "micro", 128, 64)
    assert t == enc.shape[1] == 16
    assert fc.get_total_flops() == 2 * want


def test_the_east_train_step_count_equals_torchs_counter():
    cfg = {"backbone": "resnet50-micro"}
    w = {k: v.requires_grad_(not k.endswith(("running_mean", "running_var")))
         for k, v in make_weights(east_ref.layout(cfg), 0, "cpu").items()}
    x = torch.randint(0, 256, (2, 96, 96, 3), dtype=torch.uint8)
    params = [v for v in w.values() if v.requires_grad]
    with FlopCounterMode(display=False) as fc:
        score, geo = east_ref.forward(w, cfg, x)
        torch.autograd.grad(score.sum() + geo.sum(), params)
    assert fc.get_total_flops() == counts.east_train_step_flops(96, 2, "resnet50-micro", passes=1)
    one = counts.east_train_step_flops(96, 2, "resnet50-micro", passes=1)
    assert counts.east_train_step_flops(96, 2, "resnet50-micro") == 2 * one
