"""The traced sub-window: ``torch.profiler`` (CPU and CUDA activities) over
whole dispatches near the end of a traced run's window, reduced to device
busy seconds, in all and by the kind of dispatch that launched them, kernel
seconds by family (``kernels/*.json``), the top device operations and the
idle gaps by what the host was doing.
"""

from __future__ import annotations

import bisect
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from harness import spec

#: name prefix of the benchmark's own host spans (harness/program.py)
SPAN = "h100_bench."


class Profiler:
    """Starts at the first dispatch boundary at or after ``start_after``
    seconds of the window and stops at the first one at or after
    ``stop_after`` (``arm`` gives it the window's opening);
    ``spans.profiling`` follows it."""

    def __init__(self, start_after: float, stop_after: float):
        self.start_after, self.stop_after = start_after, stop_after
        self.start_at = self.stop_at = float("inf")
        self.prof = None
        self.t_start: Optional[float] = None
        self.t_stop: Optional[float] = None
        self.spans = None

    @staticmethod
    def warm(dev) -> None:
        """Start and stop a profiler once, in set-up: the first start
        initializes the tracer (CUPTI), which would otherwise eat the
        profiled sub-window."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            (torch.ones(8, device=dev) + 1).sum().item()

    def arm(self, t0: float) -> None:
        self.start_at = t0 + self.start_after
        self.stop_at = t0 + self.stop_after

    def before(self, now: float) -> None:
        if self.prof is None and self.t_stop is None and now >= self.start_at:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.t_start = time.monotonic()
            self.spans.profiling = True

    def after(self, now: float) -> None:
        if (self.prof is not None and self.t_stop is None
                and now >= self.stop_at):
            self.stop()

    def stop(self) -> None:
        if self.prof is not None and self.t_stop is None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.t_stop = time.monotonic()
            self.prof.stop()
            self.spans.profiling = False


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def summarize(prof, window_s: float, top: int = 10) -> Dict[str, Any]:
    """Device busy seconds, kernel seconds by family, the ``top`` device
    operations and the ``top`` host activities under which the device
    idled longest, from a stopped profiler."""
    table = spec.kernel_families()
    dev: List[Tuple[float, float, str]] = []
    host: List[Tuple[float, float, str]] = []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith(SPAN):  # our ranges' device shadows
                dev.append((a, b, e.name))
        elif b > a:
            host.append((a, b, e.name))
    fam_s: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    unmapped, ambiguous = set(), {}
    fam_cache: Dict[str, str] = {}
    for a, b, name in dev:
        if name not in fam_cache:
            fam, files = spec.family_of(name, table)
            fam_cache[name] = fam
            if fam == "unmapped":
                unmapped.add(name)
            elif fam == "ambiguous":
                ambiguous[name] = files
        fam = fam_cache[name]
        fam_s[fam] = fam_s.get(fam, 0.0) + (b - a) * 1e-6
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    busy = _union([(a, b) for a, b, _ in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps = _gaps(busy, host)
    kind_s = _busy_by_kind(dev, host)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": busy_s, "window_s": window_s, "family_s": fam_s,
        "kind_busy_s": kind_s,
        "device_ops": [[_short(n), s] for n, s in ops],
        "idle_gaps": gaps[:top],
        "unmapped": sorted(unmapped), "ambiguous": ambiguous,
        "kernels": len(dev),
    }


def _busy_by_kind(dev: List[Tuple[float, float, str]],
                  host: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Device busy seconds by the kind of dispatch (the benchmark's span,
    ``h100_bench.<kind>``) that launched them: each device operation goes
    to the last span that began before it did (a dispatch ends in a copy
    to the host, so its work never outlasts the next span's start);
    operations before the first span go to none."""
    spans = sorted((a, name[len(SPAN):]) for a, _, name in host
                   if name.startswith(SPAN))
    starts = [a for a, _ in spans]
    by_kind: Dict[str, List[Tuple[float, float]]] = {}
    for a, b, _ in dev:
        j = bisect.bisect_right(starts, a)
        if j:
            by_kind.setdefault(spans[j - 1][1], []).append((a, b))
    return {k: sum(b - a for a, b in _union(iv)) * 1e-6
            for k, iv in by_kind.items()}


def _gaps(busy: List[Tuple[float, float]],
          host: List[Tuple[float, float, str]]) -> List[List[Any]]:
    """Idle seconds between the device's busy stretches, summed by what the
    host was doing at each gap's middle: the benchmark's span around it
    (or "between dispatches") and the innermost host operation there."""
    if not busy or not host:
        return []
    spans = sorted(h for h in host if h[2].startswith(SPAN))
    ops = sorted(h for h in host if not h[2].startswith(SPAN))
    span_starts = [h[0] for h in spans]
    op_starts = [h[0] for h in ops]
    lo = min(h[0] for h in host)
    hi = max(h[1] for h in host)
    edges = [(lo, busy[0][0])] + [(busy[i][1], busy[i + 1][0])
                                  for i in range(len(busy) - 1)]
    edges.append((busy[-1][1], hi))
    acc: Dict[str, float] = {}
    for a, b in edges:
        if b - a <= 0:
            continue
        mid = (a + b) / 2
        label = "between dispatches"
        j = bisect.bisect_right(span_starts, mid)
        if j and spans[j - 1][1] >= mid:
            label = spans[j - 1][2][len(SPAN):]
        inner = None
        j = bisect.bisect_right(op_starts, mid)
        for k in range(j - 1, max(-1, j - 400), -1):
            s, e, name = ops[k]
            if e >= mid and (inner is None or e - s < inner[1] - inner[0]):
                inner = (s, e, name)
        if inner is not None:
            label += f" > {_short(inner[2], 60)}"
        acc[label] = acc.get(label, 0.0) + (b - a) * 1e-6
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])]
