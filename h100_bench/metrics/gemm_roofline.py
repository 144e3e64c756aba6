"""The W4A8 GEMMs' share of their roofline: the least seconds of the
profiled dispatches' GEMM work (harness/counts.py) over the device seconds
of the kernels of family "gemm" in the trace, in %."""


def read(ctx):
    return ctx.roofline("gemm_least", "gemm")
