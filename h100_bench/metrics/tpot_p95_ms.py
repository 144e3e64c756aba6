"""95th percentile over requests of (t_done - t_first_token) / (n - 1), in
ms: closed loop, the requests that finished inside the window; open loop,
every request due in it (host clock)."""

from harness import stats


def read(ctx):
    v = stats.percentile(ctx.tpots(), 95)
    return None if v is None else 1e3 * v
