"""Active rows per decode step, over every decode dispatch that started in
the window (the benchmark's spans around ``Engine._decode_tick``): how full
the scheduler keeps the batch."""


def read(ctx):
    ticks = ctx.dispatches("decode")
    steps = sum(s["desc"]["steps"] for s in ticks)
    if not steps:
        return None
    rows = sum(len(s["desc"]["rows"]) * s["desc"]["steps"] for s in ticks)
    return rows / steps
