"""Host ms per decode tick (one captured-graph replay and its host work),
over the unprofiled decode dispatches that started in the window."""


def read(ctx):
    spans = ctx.dispatches("decode", profiled=False)
    if not spans:
        return None
    return 1e3 * sum(s["t1"] - s["t0"] for s in spans) / len(spans)
