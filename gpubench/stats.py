"""Statistics taken over every sample of a window."""

from __future__ import annotations

import math


def percentile(values, p: float) -> float | None:
    """The p-th percentile of all `values` by linear interpolation between
    closest ranks (numpy's default); an infinite sample (a failure) ranks
    above all others, and a percentile that reaches it is infinite."""
    xs = sorted(values)
    if not xs:
        return None
    rank = (len(xs) - 1) * p / 100.0
    lo, hi = math.floor(rank), math.ceil(rank)
    if math.isinf(xs[hi]) or math.isinf(xs[lo]):
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)
