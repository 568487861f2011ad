"""Rates and percentiles, each over all of the window's work."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of every value: the smallest
    value that at least ``q`` percent of them do not exceed."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return float(s[max(0, math.ceil(q / 100.0 * len(s)) - 1)])


def rate(work: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return float(work) / float(seconds)


def summary(values) -> list:
    """``[count, min, p25, p50, p75, max]`` of every value (nearest-rank
    percentiles)."""
    return [len(values), float(min(values)), percentile(values, 25), percentile(values, 50),
            percentile(values, 75), float(max(values))]
