"""The whole step's share of the chip's peak: the least seconds the
window's unprofiled dispatches' work needs (per dispatch the larger of its
int8 GEMM operations at the int8 peak plus its attention and head
operations at the bf16 peak, and its bytes at the HBM bandwidth;
harness/counts.py) over their host-clock seconds, in %."""


def read(ctx):
    return ctx.mfu()
