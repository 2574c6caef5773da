"""Each fault a cell can have, planted under the timed path of a whole run
(at tiny sizes on the CPU, under the configurations' own limits), makes
``correct`` false; the same run without it is correct."""

import time

import pytest

from perfbench import harness
from perfbench.calibrate import fault

SEED = 2**31 + 17
FAULTS = [
    ("trba-tiny.recognize-tiny", "token_altered", SEED),
    ("trba-tiny.recognize-tiny", "recognize_half_batch", SEED),
    ("trba-tiny.recognize-tiny", "step_unchanged", SEED),
    # the tiny decoder's random weights on this seed make a greedy path that
    # one beam and eight do not share (on some seeds they coincide)
    ("trba-tiny.recognize-tiny", "greedy_for_beam", 2**31 + 99),
    ("east-tiny.train-tiny", "half_batch", SEED),
    ("east-tiny.train-tiny", "state_unchanged", SEED),
]


@pytest.mark.parametrize("name,variant,seed", FAULTS)
def test_a_planted_fault_makes_the_run_incorrect(tiny_root, name, variant, seed):
    cell = harness.load_cell(tiny_root, name, seed, 0.3, False, "cpu")
    with fault(variant):
        out = harness.run(cell, time.perf_counter())
    assert out["result"]["correct"] is False, out["result"]["checks"]
