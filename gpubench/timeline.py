"""The device timeline of a traced stretch: busy time, idle share, the
heaviest device operations and the longest idle gaps by what the host was
doing.  Pure functions over intervals, so the CPU tests can hold them."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The union of intervals, clipped to [lo, hi], as sorted disjoint intervals."""
    out: List[Interval] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """Time in [lo, hi] during which at least one interval runs."""
    return sum(b - a for a, b in union(intervals, lo, hi))


def idle_share(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """The share of [lo, hi] in which no interval runs."""
    if hi <= lo:
        raise ValueError("empty window")
    return 1.0 - busy(intervals, lo, hi) / (hi - lo)


def gaps(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The idle stretches of [lo, hi] between the intervals."""
    out, t = [], lo
    for a, b in union(intervals, lo, hi):
        if a > t:
            out.append((t, a))
        t = b
    if t < hi:
        out.append((t, hi))
    return out


def top_by_name(named: Iterable[Tuple[str, float]], k: int = 10) -> List[List]:
    """[[name, total], ...] of the k largest totals, largest first."""
    tot: Dict[str, float] = defaultdict(float)
    for name, v in named:
        tot[name] += v
    return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def innermost(spans: Sequence[Tuple[float, float, str]], t: float) -> str:
    """The name of the innermost span covering time t (the covering span
    that started last), or "" where none covers it."""
    starts = [s[0] for s in spans]
    i = bisect.bisect_right(starts, t)
    best = ""
    best_start = None
    # spans are few per gap's neighbourhood; walk back while they can cover t
    for j in range(i - 1, -1, -1):
        a, b, name = spans[j]
        if a <= t < b and (best_start is None or a > best_start):
            best, best_start = name, a
            break
    return best


def gap_causes(device: Iterable[Interval], host_spans: Sequence[Tuple[float, float, str]],
               lo: float, hi: float, k: int = 10) -> List[List]:
    """The idle gaps of the device in [lo, hi], summed by the innermost host
    span (sorted by start) that was open when each gap began."""
    spans = sorted(host_spans)
    named = []
    for a, b in gaps(device, lo, hi):
        named.append((innermost(spans, a) or "outside any span", b - a))
    return top_by_name(named, k)
