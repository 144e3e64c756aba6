"""Host ms per 1000 prompt tokens prefilled, over the unprofiled prefill
dispatches that started in the window (the benchmark's spans around
``Engine._admit_batch`` / ``_prefill_chunk``)."""


def read(ctx):
    spans = ctx.dispatches("prefill", profiled=False)
    toks = sum(t for s in spans for _, t in s["desc"]["rows"])
    if not toks:
        return None
    return 1e6 * sum(s["t1"] - s["t0"] for s in spans) / toks
