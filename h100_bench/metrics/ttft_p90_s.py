"""90th percentile over every request due in the window of the seconds from
its due time to its first token (host clock; a request that never answered
counts as the slowest).  At 0.8 of an open cell's knee a 51 s window holds
~100-125 requests: the 90th is the highest percentile with ten or more
beyond it."""

from harness import stats


def read(ctx):
    return stats.percentile(ctx.ttfts(), 90)
