"""The benchmark's arithmetic on host-clock samples: rates, percentiles and
spreads."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def rate(work: float, start: float, end: float) -> float:
    """Work per second over the interval [start, end]."""
    if end <= start:
        raise ValueError(f"empty interval [{start}, {end}]")
    return work / (end - start)


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 < q < 100) by the nearest-rank rule: the
    smallest value with at least q% of the values at or below it, so a
    reported tail is a sample that was measured."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def union_length(spans) -> float:
    """The length of the union of intervals ``(start, end)``."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    total, (cs, ce) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > ce:
            total += ce - cs
            cs, ce = s, e
        else:
            ce = max(ce, e)
    return total + (ce - cs)


def gaps(spans, start: float, end: float):
    """The idle intervals of [start, end] that no span of ``spans``
    covers, as (start, end) pairs in time order."""
    out, cur = [], start
    for s, e in sorted(spans):
        if s > cur:
            out.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        out.append((cur, end))
    return [(a, b) for a, b in out if b > a]
