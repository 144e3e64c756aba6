"""Generated tokens delivered inside the window over the window's seconds
(host clock; closed-loop cells)."""


def read(ctx):
    return ctx.window.tokens_in_window / ctx.window.seconds
