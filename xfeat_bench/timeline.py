"""Arithmetic of the window and of the device timeline, on plain numbers
so that it can be checked by hand.

- `percentile`: linear interpolation between the closest ranks (numpy's
  default), of all samples.
- `union_length` / `gaps`: the device's busy time as the union of its
  operation intervals, and the idle intervals between them, clipped to a
  window (the arithmetic of the port's `utils/profiling.profile_call`).
- `innermost`: which span of a set of nested spans holds an instant.
"""

from __future__ import annotations

import bisect
import math
from typing import List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) of `values`."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def _merged(intervals: Sequence[Interval], window: Interval
            ) -> List[Interval]:
    lo, hi = window
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_length(intervals: Sequence[Interval], window: Interval) -> float:
    """Length of the union of `intervals` inside `window`."""
    return sum(b - a for a, b in _merged(intervals, window))


def gaps(intervals: Sequence[Interval], window: Interval) -> List[Interval]:
    """The parts of `window` that no interval covers."""
    out, reach = [], window[0]
    for a, b in _merged(intervals, window):
        if a > reach:
            out.append((reach, a))
        reach = max(reach, b)
    if reach < window[1]:
        out.append((reach, window[1]))
    return out


class Spans:
    """Named host intervals, possibly nested; `innermost(t)` is the name
    of the shortest one that holds t, or None."""

    def __init__(self, spans: Sequence[Tuple[str, float, float]]):
        self._spans = sorted(spans, key=lambda s: s[1])
        self._starts = [s[1] for s in self._spans]
        self._longest = max((s[2] - s[1] for s in self._spans), default=0.0)

    def innermost(self, t: float) -> Optional[str]:
        best = None
        i = bisect.bisect_right(self._starts, t) - 1
        while i >= 0 and self._spans[i][1] >= t - self._longest:
            name, a, b = self._spans[i]
            if a <= t < b and (best is None or b - a < best[1]):
                best = (name, b - a)
            i -= 1
        return None if best is None else best[0]
