"""Window and percentile arithmetic."""

from __future__ import annotations

import math


def percentile(values, q):
    """The q-th percentile (0 <= q <= 100) of `values`, interpolated
    linearly between the order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def per_item_ms(window_s, n):
    """Wall time of a window over the items completed in it, in ms."""
    if n <= 0:
        raise ValueError("no item completed in the window")
    return window_s / n * 1e3
