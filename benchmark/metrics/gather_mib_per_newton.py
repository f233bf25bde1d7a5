"""MiB moved by the program's index gathers per Newton iteration in the
traced window: the gathered rows and their indices, from shapes, at
every call site (``gather_bytes_<site>`` in ``solver.stats``;
``softx_2020_200_tpu_torch/core/spans.py``).  A count, the same for
every run of one seed."""

SITES = ("transfer", "operator", "constraints", "smoother")


def read(ctx):
    n = ctx.stats.get("newton_iterations")
    total = sum(ctx.stats.get(f"gather_bytes_{s}", 0) for s in SITES)
    if not n or not total:
        return None
    return total / 2 ** 20 / n
