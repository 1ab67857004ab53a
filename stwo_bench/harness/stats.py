"""The arithmetic of the end-to-end metrics and of the trace."""

from __future__ import annotations

import math


def p95(values: list) -> float:
    """The nearest-rank 95th percentile: the least value that at least 95%
    of `values` do not exceed."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def union(intervals: list) -> list:
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(intervals: list, lo: float, hi: float) -> float:
    """How much of [lo, hi) the intervals cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in union(intervals))


def gaps(intervals: list, lo: float, hi: float) -> list:
    """The [start, end) stretches of [lo, hi) no interval covers."""
    out, at = [], lo
    for s, e in union(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]
