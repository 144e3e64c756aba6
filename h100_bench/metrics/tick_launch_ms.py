"""Mean host ms inside a decode tick's graph launch call (the engine's
stamps around it, no profiler attached; harness/records.py), over the
ticks that start in the window's unprofiled part; None off the card, where
no graph is launched."""

from harness import records


def read(ctx):
    ticks = records.dispatches(ctx, "decode")
    if not ticks or any(t["device_start"] is None for t in ticks):
        return None
    return 1e3 * sum(t["t_launched"] - t["t_packed"]
                     for t in ticks) / len(ticks)
