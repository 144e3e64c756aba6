"""Seconds from the process's start to the window's first request: import,
kernel load, weights, the cell's warm-up and graph capture (host clock)."""


def read(ctx):
    return ctx.setup_s
