"""The device's idle share of the window's unprofiled part: 1 − (the
trace's device-busy seconds per decode step and per prefilled token
position, times the steps and positions of the unprofiled dispatches) over
that part's host-clock seconds, in %.  No peak enters (harness/context.py:
Context.idle)."""


def read(ctx):
    return ctx.idle()
