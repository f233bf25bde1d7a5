"""Host milliseconds per Newton iteration in the traced window, without
its waits for the device: the solves' seconds less the ``sync`` spans'
seconds (``newton_seconds``, ``sync_wait_s`` in ``solver.stats``) over
the Newton iterations.  The profiler slows it alike on every commit."""


def read(ctx):
    n = ctx.stats.get("newton_iterations")
    total, wait = ctx.stats.get("newton_seconds"), ctx.stats.get(
        "sync_wait_s")
    if not n or not total or not wait:
        return None
    return 1e3 * (total - wait) / n
