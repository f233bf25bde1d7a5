"""Newton iterations per time step in the traced window
(``solver.stats``)."""


def read(ctx):
    return ctx.stats["newton_iterations"] / ctx.steps if ctx.steps else None
