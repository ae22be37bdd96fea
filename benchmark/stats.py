"""Statistics of the metrics."""

from __future__ import annotations

import math


def nearest_rank(values, q: float) -> float:
    """The nearest-rank ``q`` quantile (0 < q <= 1): the smallest value with
    at least ``q`` of the sample at or below it. With n values,
    ``n - ceil(q n)`` of them lie beyond it."""
    if not values:
        raise ValueError("no values")
    if not 0 < q <= 1:
        raise ValueError(f"q must lie in (0, 1], got {q}")
    xs = sorted(values)
    return xs[max(math.ceil(q * len(xs)) - 1, 0)]

