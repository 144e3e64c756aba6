"""Tracing and profiling helpers (port of qqq_tpu/utils/profiling.py).

:class:`StageTimer` aggregates named stage durations into a report (the
calibration pipeline's spans).  The card runs asynchronously to the host,
so a stage given a ``fence`` (a tensor, or a tree of them, that the stage
produced) waits for the card before it is timed: ``torch.cuda.synchronize``
on the device of the first CUDA tensor found.  :func:`device_trace` wraps
``torch.profiler`` around a block and writes a Chrome trace of host and
device activity to ``log_dir`` (viewable in Perfetto).
:class:`DeviceSpans` places a sequence of dispatches' device work on the
host's monotonic clock with CUDA events, adding no synchronization (the
serving engine's dispatch records, serve/engine.py).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

import torch

logger = logging.getLogger("qqq_tpu_torch")


def _cuda_device(tree) -> Optional[torch.device]:
    """The device of the first CUDA tensor in ``tree`` (nested lists,
    tuples and dicts), or None."""
    if isinstance(tree, torch.Tensor):
        return tree.device if tree.is_cuda else None
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            dev = _cuda_device(x)
            if dev is not None:
                return dev
    return None


class StageTimer:
    """Accumulates named stage durations (calibration pipeline spans)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, fence=None):
        t0 = time.time()
        try:
            yield
        finally:
            dev = _cuda_device(fence)
            if dev is not None:
                torch.cuda.synchronize(dev)
            dt = time.time() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            logger.debug("stage %s: %.3fs", name, dt)

    def report(self) -> str:
        lines = ["stage timings:"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"  {name:<30s} {self.totals[name]:8.2f}s"
                f"  x{self.counts[name]}"
            )
        return "\n".join(lines)


class DeviceSpans:
    """The device span of each of a sequence of dispatches, and the device
    idle before it, on ``time.monotonic()``, from CUDA events that add no
    synchronization.

    A dispatch marks ``start = mark()`` just before its first device work,
    hands its record over with :meth:`close` once its work is enqueued, and
    ends its device work with a host↔device sync that it makes anyway,
    right after which it stamps ``record["t_synced"]`` and calls
    :meth:`synced`.  Now and then (every :data:`ANCHOR_S` seconds)
    :meth:`synced` records an anchor: after a sync the stream is empty, so
    the anchor runs within microseconds of the host stamp taken beside it,
    and a start event lies at that stamp plus or minus the device time
    between the two.  A record's fields ``device_start``, ``device_end``
    (its sync) and ``gap_before_s`` (the device's idle from the previous
    dispatch's end to this start) are filled in by :meth:`fill`, which the
    next dispatch calls while the device works on it, so that reading the
    event costs no dispatch any time, or by :meth:`flush`.  Events come
    from a small pool and go back to it once read, so none is created a
    dispatch after the first few.  The events go on the thread's current
    stream.

    Off the card every method returns None and the fields stay None."""

    #: seconds between anchors (the device's clock and the host's drift
    #: apart by well under a microsecond in that time)
    ANCHOR_S = 1.0

    def __init__(self, device: torch.device):
        self.on = device.type == "cuda"
        self._index = device.index or 0
        self._pool: List[torch.cuda.Event] = []
        #: the current stream, as a raw handle and as a Stream
        self._raw: Optional[int] = None
        self._stream = None
        #: (anchor event, its host stamp)
        self._anchor: Optional[tuple] = None
        #: (record, start event, its host stamp) of the dispatches handed
        #: over and not yet filled in, oldest first
        self._open: List[tuple] = []
        #: the last filled-in record's device end
        self._last_end: Optional[float] = None

    def mark(self) -> Optional[torch.cuda.Event]:
        """A timing event recorded on the current stream (None off the
        card)."""
        if not self.on:
            return None
        raw = torch._C._cuda_getCurrentRawStream(self._index)
        if raw != self._raw:
            self._raw = raw
            self._stream = torch.cuda.current_stream(self._index)
        ev = (self._pool.pop() if self._pool
              else torch.cuda.Event(enable_timing=True))
        ev.record(self._stream)
        return ev

    def close(self, record: Dict[str, Any], start, t_start: float) -> None:
        """Hand over a dispatch's ``record`` before its sync: ``start`` was
        marked at host time ``t_start``."""
        if not self.on:
            return
        if self._open and "t_synced" not in self._open[-1][0]:
            # that dispatch never reached its sync (it raised): no span
            self._pool.append(self._open.pop()[1])
        self._open.append((record, start, t_start))

    def synced(self, now: float) -> None:
        """Right after a sync, ``now`` its host stamp: anchor the device's
        clock anew if the last anchor is :data:`ANCHOR_S` old."""
        if self.on and (self._anchor is None
                        or now - self._anchor[1] >= self.ANCHOR_S):
            old = self._anchor
            self._anchor = (self.mark(), time.monotonic())
            if old is not None:
                self._pool.append(old[0])

    def fill(self) -> None:
        """Fill in the records handed over whose sync has returned (their
        start events ran before it), once the anchor has run: call it while
        the device works on a later dispatch."""
        while (self._open and "t_synced" in self._open[0][0]
               and self._anchor[0].query()):
            self._fill(*self._open.pop(0))

    def flush(self) -> None:
        """Wait for the device and fill in every record whose sync has
        returned (for a reader, on the dispatching thread or between
        dispatches)."""
        if self._open:
            torch.cuda.synchronize(self._index)
            self.fill()

    def _fill(self, rec: Dict[str, Any], start, t_start: float) -> None:
        anchor, t_a = self._anchor
        if t_start >= t_a:
            rec["device_start"] = t_a + 1e-3 * anchor.elapsed_time(start)
        else:
            rec["device_start"] = t_a - 1e-3 * start.elapsed_time(anchor)
        rec["device_end"] = rec["t_synced"]
        if self._last_end is not None:
            rec["gap_before_s"] = rec["device_start"] - self._last_end
        self._last_end = rec["device_end"]
        self._pool.append(start)


@contextlib.contextmanager
def device_trace(log_dir: str = "qqq_tpu_torch_trace"):
    """``torch.profiler`` over the block (CPU activity, and the card's when
    one is present); on exit the card is synchronized and the trace written
    to ``log_dir/trace.json``.  Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
