"""The window's arithmetic: rates from totals, tails over every call."""

import time

import pytest
import torch

from perfbench.harness import measure
from perfbench.window import Window, percentile, rate


def test_rate_is_all_the_work_over_all_the_seconds():
    assert rate(900, 30.0) == 30.0
    with pytest.raises(ValueError):
        rate(1, 0.0)


def test_percentile_interpolates_between_ranks():
    assert percentile([1.0, 2.0, 3.0, 4.0, 5.0], 50) == 3.0
    assert percentile(list(range(101)), 95) == 95.0
    assert percentile([10.0, 20.0], 95) == pytest.approx(19.5)


class _Stalling:
    """A fake session: calls of 2 ms, and of 60 ms every 10th call."""

    unit = "words"

    def __init__(self):
        self.i = 0

    def call(self):
        self.i += 1
        time.sleep(0.06 if self.i % 10 == 0 else 0.002)
        return 5

    def finish(self):
        pass


def test_a_stall_in_one_call_in_ten_sets_the_p95_and_lowers_the_rate():
    win = measure(_Stalling(), 0.8, torch.device("cpu"))
    assert win.calls >= 20
    assert win.work == 5 * win.calls
    assert 1e3 * percentile(win.call_seconds, 95) > 40  # every stall counts, none averaged away
    assert 1e3 * percentile(win.call_seconds, 50) < 20
    assert rate(win.work, win.seconds) == pytest.approx(win.work / win.seconds)
    assert win.seconds >= sum(win.call_seconds)
    assert rate(win.work, win.seconds) < 5 / 0.002 * 0.5


def test_the_end_to_end_readers_take_their_unit_only(tiny_root):
    from perfbench.harness import load_module

    win = Window("words", work=100, seconds=2.0, call_seconds=[0.1, 0.2, 0.3])
    read = lambda name: load_module(tiny_root / "perfbench" / "e2e" / f"{name}.py").read(win, 7.5)
    assert read("words_per_s") == 50.0
    assert read("recognize_p95_ms") == pytest.approx(290.0)
    assert read("train_samples_per_s") is None
    assert read("setup_s") == 7.5
