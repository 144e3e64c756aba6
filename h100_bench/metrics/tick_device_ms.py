"""Mean device ms of a decode tick, from its graph launch to its report's
arrival on the host (the engine's CUDA events, harness/records.py), over
the ticks that start in the window's unprofiled part; None off the card."""

from harness import records


def read(ctx):
    ticks = records.dispatches(ctx, "decode")
    if not ticks or any(t["device_start"] is None for t in ticks):
        return None
    return 1e3 * sum(t["device_end"] - t["device_start"]
                     for t in ticks) / len(ticks)
