"""Window arithmetic: rates over the whole window, tails over all samples."""

from __future__ import annotations

import math
from typing import Sequence


def per_item_ms(window_s: float, completed: int) -> float:
    """The window's wall time over the items (frames, steps) completed in it."""
    if completed <= 0:
        raise ValueError("no item completed in the window")
    return window_s * 1e3 / completed


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 < q < 100) of all values, linearly
    interpolated between the order statistics (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
