"""Order statistics of the benchmark's own timings."""

from __future__ import annotations

from typing import Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """The p-th percentile by linear interpolation between the closest ranks
    (numpy's default rule)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * p / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
