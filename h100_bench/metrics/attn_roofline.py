"""Attention's share of its roofline: the least seconds of the profiled
dispatches' attention work (prefill and decode attention, KV writes;
harness/counts.py) over the device seconds of the kernels of family "attn"
in the trace, in %."""


def read(ctx):
    return ctx.roofline("attn_least", "attn")
