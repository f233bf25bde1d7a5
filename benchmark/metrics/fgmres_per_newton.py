"""FGMRES iterations per Newton iteration in the traced window
(``solver.stats``): what the preconditioner saves."""


def read(ctx):
    n = ctx.stats["newton_iterations"]
    return ctx.stats["linear_iterations"] / n if n else None
