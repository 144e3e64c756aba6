"""The device's idle between dispatches, as a share of the window's
unprofiled part: the sum of each dispatch's ``gap_before_s`` (from the
previous dispatch's end, its sync, to this one's first device work, placed
on the host clock by the engine's CUDA events; harness/records.py) over
that part's host-clock seconds, in %.  The idle inside a dispatch (an eager
prefill's host-bound stretches) is not counted; None off the card."""

from harness import records


def read(ctx):
    gaps = records.gaps(ctx)
    if not gaps:
        return None
    wall = sum(hi - lo for lo, hi in records.part(ctx))
    return 100.0 * sum(gaps) / wall if wall > 0 else None
