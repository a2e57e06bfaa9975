"""Arithmetic of the end-to-end and device metrics, on plain numbers."""
from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: int) -> float:
    """The q-th percentile (1..99) of `values`, interpolated between order
    statistics as ``statistics.quantiles(..., n=100, method="inclusive")``
    does."""
    if len(values) < 2:
        raise ValueError("a percentile needs two or more values")
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def intervals(stamps: Sequence[float]) -> List[float]:
    """Differences between consecutive time stamps."""
    return [b - a for a, b in zip(stamps, stamps[1:])]


def union(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) spans as sorted, disjoint spans."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_and_gaps(spans: Iterable[Tuple[float, float]], lo: float, hi: float):
    """(busy time, idle gaps) of the window [lo, hi]: the length of the
    union of `spans` clipped to it, and the (start, end) stretches of the
    window that no span covers."""
    busy, gaps, at = 0.0, [], lo
    for a, b in union((max(a, lo), min(b, hi)) for a, b in spans):
        if a > at:
            gaps.append((at, a))
        busy += b - a
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    return busy, gaps
