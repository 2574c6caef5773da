"""The measured window's arithmetic: a rate is all the work over all the
window's seconds, a tail is taken over every call of the window."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List


@dataclass
class Window:
    """What one measured window did: ``unit`` of the work ("words",
    "samples"), ``work`` done by the calls that completed, ``seconds`` from
    the window's start to the end of its last call, and each call's
    host-clock seconds."""

    unit: str
    work: int = 0
    seconds: float = 0.0
    call_seconds: List[float] = field(default_factory=list)

    @property
    def calls(self) -> int:
        return len(self.call_seconds)


def rate(work: float, seconds: float) -> float:
    """All the work over all the seconds."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return work / seconds


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile (0–100) of every value, by linear
    interpolation between the closest ranks (numpy's default)."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
