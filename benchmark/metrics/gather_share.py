"""Share of the device time in index gathers and scatters: the kernels
whose names hold one of ``PATTERNS``."""

PATTERNS = ("vectorized_gather_kernel", "index_elementwise_kernel",
            "indexSelect", "index_select", "scatter_gather", "index_put",
            "scatter_add")


def read(ctx):
    if ctx.trace is None:
        return None
    total = ctx.trace.device_s()
    return 100.0 * ctx.trace.device_s(PATTERNS) / total if total else None
