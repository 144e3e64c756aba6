"""Tracing and profiling helpers (port of qqq_tpu/utils/profiling.py).

:class:`StageTimer` aggregates named stage durations into a report (the
calibration pipeline's spans).  The card runs asynchronously to the host,
so a stage given a ``fence`` (a tensor, or a tree of them, that the stage
produced) waits for the card before it is timed: ``torch.cuda.synchronize``
on the device of the first CUDA tensor found.  :func:`device_trace` wraps
``torch.profiler`` around a block and writes a Chrome trace of host and
device activity to ``log_dir`` (viewable in Perfetto).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Optional

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
