"""Wall seconds per time step: the window's wall time (from a
synchronise to a synchronise) over every step it completed."""


def read(ctx):
    return ctx.window_s / ctx.steps if ctx.steps else None
