"""What a metric reader (``metrics/<name>.py``, ``read(ctx)``) reads: the
window, the set-up time, the dispatch spans and the trace summary of a
run, with the arithmetic several readers share.  A reader that finds
nothing to read returns None, and the metric is left out of the line."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from harness import counts, stats


class Context:
    def __init__(self, cell: Dict[str, Any], window, setup_s: float,
                 spans: Optional[List[Dict[str, Any]]] = None,
                 trace: Optional[Dict[str, Any]] = None,
                 peaks: Optional[Dict[str, Any]] = None,
                 profiled: Optional[tuple] = None):
        self.cell = cell
        self.cfg = cell["config"]
        self.loop = cell["traffic"]["loop"]
        self.window = window
        self.setup_s = setup_s
        self.spans = spans
        self.trace = trace
        self.peaks = peaks
        #: (start, stop) host seconds of the profiled sub-window
        self.profiled = profiled
        self._work: Dict[int, Dict[str, float]] = {}

    # -- requests ----------------------------------------------------------

    def answered(self) -> List[Any]:
        """Requests whose latency the tails cover: closed loop, those that
        finished inside the window; open loop, every one due in it (the
        drain finished them)."""
        w = self.window
        if self.loop == "closed":
            return [r for r in w.requests if r.done and not r.cancelled
                    and r.t_done is not None and r.t_done <= w.t_end]
        return list(w.requests)

    def ttfts(self) -> List[float]:
        """Seconds from each due request's due time to its first token
        (``inf`` for one that never answered)."""
        return [(r.t_first_token - due) if r.t_first_token is not None
                else math.inf
                for r, due in zip(self.window.requests, self.window.due)]

    def tpots(self) -> List[float]:
        out = []
        for r in self.answered():
            if r.t_first_token is None or r.t_done is None or r.cancelled:
                out.append(math.inf)
                continue
            v = stats.tpot(r.t_first_token, r.t_done, len(r.output_tokens))
            if v is not None:
                out.append(v)
        return out

    # -- dispatch spans ----------------------------------------------------

    def dispatches(self, kind: Optional[str] = None,
                   profiled: Optional[bool] = None) -> List[Dict[str, Any]]:
        """Spans of the dispatches that started inside the window (from its
        open to its close), of one ``kind`` and profiled or not."""
        if self.spans is None:
            return []
        w = self.window
        end = w.closed_at if w.closed_at is not None else w.t_end
        return [s for s in self.spans
                if w.t0 <= s["t0"] < end
                and (kind is None or s["desc"]["kind"] == kind)
                and (profiled is None or s["profiled"] == profiled)]

    def work(self, span: Dict[str, Any]) -> Dict[str, float]:
        key = id(span)
        if key not in self._work:
            self._work[key] = counts.dispatch(self.cfg, span["desc"],
                                              self.peaks)
        return self._work[key]

    def least(self, spans: List[Dict[str, Any]], part: str = "least") -> float:
        return sum(self.work(s)[part] for s in spans)

    def family_s(self, family: str) -> Optional[float]:
        if self.trace is None:
            return None
        return self.trace["family_s"].get(family)

    def roofline(self, part: str, family: str) -> Optional[float]:
        """Least seconds of ``part`` of the profiled dispatches' work over
        the device seconds of the kernels of ``family``, in %."""
        dev = self.family_s(family)
        spans = self.dispatches(profiled=True)
        if not dev or not spans or self.peaks is None:
            return None
        return 100.0 * self.least(spans, part) / dev

    def mfu(self) -> Optional[float]:
        """Least seconds of the window's unprofiled dispatches over their
        host-clock seconds, in %."""
        spans = self.dispatches(profiled=False)
        wall = sum(s["t1"] - s["t0"] for s in spans)
        if not spans or wall <= 0 or self.peaks is None:
            return None
        return 100.0 * self.least(spans) / wall

    def idle(self) -> Optional[float]:
        """1 − the device's busy seconds over the wall of the window's
        unprofiled part, in %.  No peak enters: the busy seconds are the
        trace's, per unit of dispatch work of each kind (a decode step; a
        prefilled token position, bucket padding included), times the units
        the unprofiled dispatches did; the wall is the host clock's."""
        if self.trace is None or self.profiled is None:
            return None
        w = self.window
        end = w.closed_at if w.closed_at is not None else w.t_end
        wall = (end - w.t0) - (self.profiled[1] - self.profiled[0])
        busy = 0.0
        for kind, dev_s in self.trace["kind_busy_s"].items():
            prof = sum(map(_units, self.dispatches(kind, profiled=True)))
            if prof <= 0:
                return None
            rest = sum(map(_units, self.dispatches(kind, profiled=False)))
            busy += dev_s / prof * rest
        if wall <= 0 or busy <= 0:
            return None
        return 100.0 * (1.0 - busy / wall)


def _units(span: Dict[str, Any]) -> float:
    """A dispatch's work in the units ``Context.idle`` scales by: decode
    steps, or a prefill's token positions, padding included."""
    d = span["desc"]
    return d["steps"] if d["kind"] == "decode" else d["padded"]
