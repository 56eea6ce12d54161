"""Order statistics the readers share."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile by the nearest-rank rule: the smallest value
    with at least q% of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]
