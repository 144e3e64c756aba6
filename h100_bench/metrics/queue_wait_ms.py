"""Mean ms a request waited for a slot (``Request.t_admit`` −
``t_enqueue``, host clock), over the requests first admitted in the
window's unprofiled part (harness/records.py)."""

from harness import records


def read(ctx):
    reqs = records.admitted(ctx)
    if not reqs:
        return None
    return 1e3 * sum(r.t_admit - r.t_enqueue for r in reqs) / len(reqs)
