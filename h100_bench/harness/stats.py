"""Percentiles and window arithmetic over host-clock stamps.

Every tail is taken over all the requests it names, never from medians of
chunks; every rate over all the work and all the seconds of the window.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (0..100) by linear interpolation between the
    two nearest ranks (rank (n − 1)·q/100 of the sorted values); None for
    no values.  A value of ``inf`` (a request that never answered) counts
    as the slowest."""
    v = sorted(values)
    if not v:
        return None
    r = (len(v) - 1) * q / 100.0
    lo = math.floor(r)
    hi = min(lo + 1, len(v) - 1)
    if v[hi] == math.inf:
        return math.inf if r > lo or v[lo] == math.inf else v[lo]
    return v[lo] + (v[hi] - v[lo]) * (r - lo)


def tpot(t_first: float, t_done: float, n_tokens: int) -> Optional[float]:
    """Seconds per output token after the first; None below two tokens."""
    if n_tokens < 2:
        return None
    return (t_done - t_first) / (n_tokens - 1)

