"""Device-to-host reads per Newton iteration in the traced window
(``NewtonResult.host_syncs`` summed in ``solver.stats``)."""


def read(ctx):
    n = ctx.stats["newton_iterations"]
    return ctx.stats["host_syncs"] / n if n else None
