"""The end-to-end arithmetic: rates over a whole window and tails over
every request in it."""

from __future__ import annotations

import math


def rate(work: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, linearly interpolated
    between the two nearest ranks (numpy's default rule)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def mean(values) -> float:
    xs = [float(v) for v in values]
    if not xs:
        raise ValueError("no samples")
    return sum(xs) / len(xs)
