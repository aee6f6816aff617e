"""The arithmetic of tails, medians, rates and spreads, over all samples."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between order
    statistics (numpy's default): over every sample, none dropped."""
    x = sorted(values)
    if not x:
        raise ValueError("percentile of no samples")
    h = (len(x) - 1) * q / 100.0
    lo = math.floor(h)
    hi = min(lo + 1, len(x) - 1)
    return x[lo] + (h - lo) * (x[hi] - x[lo])


def median(values) -> float:
    return statistics.median(values)


def rate(count: int, seconds: float) -> float:
    return count / seconds


def spread(values) -> float:
    """Distance between the first and third quartile (Python's
    ``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed_spread(values) -> float:
    """The spread with the run farthest from the median left out, where
    that narrows it: what a bound's tightness is judged by, a set at a
    time."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    rest = [v for i, v in enumerate(values) if i != far]
    return min(spread(values), spread(rest)) if len(rest) >= 2 else spread(values)
