"""The share of whole-bucket prefill dispatches that replayed a captured
graph: the prefill records that start in the window's unprofiled part
(harness/records.py) whose ``graph`` field reads "replay", over all of
them, in %.  A capture inside the window, or a prefill run eagerly, counts
against it.  None for a program whose records lack the field, for an
engine that prefills in chunks (no whole-bucket prefill), or where no
prefill started."""

from harness import records


def read(ctx):
    if getattr(ctx.window.eng, "prefill_chunk", 0):
        return None
    recs = records.dispatches(ctx, "prefill")
    if not recs or any("graph" not in r for r in recs):
        return None
    return 100.0 * sum(r["graph"] == "replay" for r in recs) / len(recs)
