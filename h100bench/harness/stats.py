"""Tails over every request, rates over the whole window, and the spread
by which bounds are set."""
from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile by nearest rank over every value: the smallest
    value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def rate(count: int, window_s: float) -> float:
    """Work completed per second over the whole window."""
    if window_s <= 0:
        raise ValueError("empty window")
    return count / window_s


def spread(values: Sequence[float]) -> float:
    """Inter-quartile distance as a share of the median (Python's
    `statistics.quantiles(values, n=4)`)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
