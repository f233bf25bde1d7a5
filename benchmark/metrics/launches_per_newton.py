"""Device kernels per Newton iteration: the kernels of the traced
window's device trace over its Newton iterations."""


def read(ctx):
    n = ctx.stats["newton_iterations"]
    if ctx.trace is None or not n or not ctx.trace.n_kernels:
        return None
    return ctx.trace.n_kernels / n
