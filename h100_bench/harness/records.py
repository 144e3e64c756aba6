"""The program's own record of its dispatches (``Engine.dispatch_log``: one
record per prefill dispatch, decode tick and verify, with its shape, host
phases on ``time.monotonic()`` and, on the card, its device span and the
device idle before it) and its requests' admission stamps
(``Request.t_admit``), over the window's unprofiled part: from its opening
to its close, less the profiled sub-window, where the profiler slows the
host.

Every function returns None where the program keeps no such record (a
program before it), or where its ring no longer reaches back to the
window's opening; a reader then returns None and its metric is left out of
the line."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple


def part(ctx) -> List[Tuple[float, float]]:
    """The window's unprofiled part: host-clock stretches [lo, hi)."""
    w = ctx.window
    end = w.closed_at if w.closed_at is not None else w.t_end
    if ctx.profiled is None:
        return [(w.t0, end)]
    a, b = ctx.profiled
    return [(lo, hi) for lo, hi in ((w.t0, min(a, end)), (max(b, w.t0), end))
            if hi > lo]


def _stretch(t: float, stretches: List[Tuple[float, float]]) -> int:
    """The index of the stretch holding ``t``, or -1."""
    for i, (lo, hi) in enumerate(stretches):
        if lo <= t < hi:
            return i
    return -1


def log(ctx) -> Optional[List[Dict[str, Any]]]:
    """The engine's records, oldest first (the window's engine is alive
    while readers run), or None."""
    recs = getattr(ctx.window.eng, "dispatch_log", None)
    if recs is None:
        return None
    if len(recs) == recs.maxlen and recs[0]["t_start"] >= ctx.window.t0:
        return None  # records of the window's start have left the ring
    return list(recs)


def dispatches(ctx, kind: Optional[str] = None
               ) -> Optional[List[Dict[str, Any]]]:
    """Records of ``kind`` that start in the unprofiled part."""
    recs = log(ctx)
    if recs is None:
        return None
    p = part(ctx)
    return [r for r in recs if (kind is None or r["kind"] == kind)
            and _stretch(r["t_start"], p) >= 0]


def admitted(ctx) -> Optional[List[Any]]:
    """The window's requests first admitted in the unprofiled part."""
    if log(ctx) is None:
        return None
    p = part(ctx)
    return [r for r in ctx.window.requests
            if r.t_admit is not None and _stretch(r.t_admit, p) >= 0]


def gaps(ctx) -> Optional[List[float]]:
    """The device idle before each record that starts in the unprofiled
    part, where the previous record's device end lies in the same stretch
    of it (so no gap reaches back into set-up or the profiled sub-window);
    None off the card, where records carry no device fields."""
    recs = log(ctx)
    if recs is None:
        return None
    p = part(ctx)
    out = []
    for prev, r in zip(recs, recs[1:]):
        i = _stretch(r["t_start"], p)
        if i < 0:
            continue
        if r["gap_before_s"] is None or prev["device_end"] is None:
            return None
        if _stretch(prev["device_end"], p) == i:
            out.append(r["gap_before_s"])
    return out
