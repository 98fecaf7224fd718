"""Plain-Python moment/robust statistics.

Parity surface of ``svtyper/statistics.py`` (SURVEY.md §2.2): ``mean``,
``stdev``, ``median`` plus the MAD-style helpers used for insert-size
histogram trimming (SPEC.md §7). Kept dependency-free: these run on tiny
per-library lists during Sample bootstrap; the hot path uses numpy/JAX.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence


def mean(values: Sequence[float]) -> float:
    values = list(values)
    if not values:
        raise ValueError("mean of empty sequence")
    return sum(values) / float(len(values))


def variance(values: Sequence[float]) -> float:
    """Population variance (matches reference ``stdev`` semantics [RECON])."""
    values = list(values)
    m = mean(values)
    return sum((x - m) ** 2 for x in values) / float(len(values))


def stdev(values: Sequence[float]) -> float:
    return math.sqrt(variance(values))


def median(values: Sequence[float]) -> float:
    values = sorted(values)
    if not values:
        raise ValueError("median of empty sequence")
    n = len(values)
    mid = n // 2
    if n % 2 == 1:
        return float(values[mid])
    return (values[mid - 1] + values[mid]) / 2.0


def mad(values: Sequence[float]) -> float:
    """Median absolute deviation."""
    m = median(values)
    return median([abs(x - m) for x in values])


def upper_mad(values: Sequence[float]) -> float:
    """Median deviation of values at or above the median (SPEC.md §7).

    Used for one-sided trimming of the insert-size histogram tail
    (SURVEY.md §8.11 [RECON]).
    """
    m = median(values)
    upper = [x - m for x in values if x >= m]
    return median(upper)


def weighted_mean_std(pairs: Iterable[tuple[int, int]]) -> tuple[float, float]:
    """Mean and population stdev of a histogram given (value, count) pairs."""
    total = 0
    wsum = 0.0
    for v, c in pairs:
        total += c
        wsum += v * c
    if total == 0:
        raise ValueError("empty histogram")
    m = wsum / total
    var = 0.0
    for v, c in pairs:
        var += c * (v - m) ** 2
    return m, math.sqrt(var / total)
