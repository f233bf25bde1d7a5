"""Share of the wall time in which no operation ran on the device: one
minus the device's busy seconds (the union of its busy intervals in the
traced window) over the wall time of the same steps run just before
without the profiler, which slows the host and not the device."""


def read(ctx):
    if ctx.trace is None or not ctx.plain_window_s or not ctx.trace.busy_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.plain_window_s)
