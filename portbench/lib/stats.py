"""The benchmark's frozen arithmetic over samples: percentiles, medians,
quartile spreads and the union of time intervals."""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Sequence, Tuple

__all__ = ["percentile", "spread", "union_length", "gaps"]


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between the
    closest ranks of the sorted values (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median, by ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def _merged(intervals: Iterable[Tuple[float, float]],
            lo: float, hi: float) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def union_length(intervals: Iterable[Tuple[float, float]], lo: float,
                 hi: float) -> float:
    """The length of the union of the intervals, clipped to [lo, hi]."""
    return sum(b - a for a, b in _merged(intervals, lo, hi))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers, in time order."""
    out, t = [], lo
    for a, b in _merged(intervals, lo, hi):
        if a > t:
            out.append((t, a))
        t = b
    if hi > t:
        out.append((t, hi))
    return out
