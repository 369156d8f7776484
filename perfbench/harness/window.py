"""Window arithmetic: a rate is all the work over all the time of the
window, a tail is the tail of every request due in it (a failed or
refused request counts as a miss, i.e. as infinitely late)."""

from __future__ import annotations

import math
from typing import Iterable, Sequence


def rate(amounts: Sequence[float], t_start: float, t_end: float) -> float:
    """Work per second: the sum of ``amounts`` over ``t_end - t_start``
    (the window's start to the last completion)."""
    span = t_end - t_start
    if span <= 0:
        raise ValueError("empty window")
    return float(sum(amounts)) / span


def percentile(latencies: Iterable[float], q: float) -> float:
    """Nearest-rank ``q``-th percentile of all latencies (``inf`` for a
    miss; the result is ``inf`` when the rank falls on a miss)."""
    xs = sorted(latencies)
    if not xs:
        raise ValueError("no requests")
    k = max(0, math.ceil(q / 100.0 * len(xs)) - 1)
    return xs[k]
