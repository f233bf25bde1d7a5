"""Host milliseconds per V-cycle in the traced window: the ``gmg.cycle``
span's seconds over its count (``vcycle_s``, ``vcycles`` in
``solver.stats``; ``softx_2020_200_tpu_torch/core/spans.py``).  The
cycle reads nothing back, so this is the host's enqueue and Python
time; the profiler slows it alike on every commit."""


def read(ctx):
    n, s = ctx.stats.get("vcycles"), ctx.stats.get("vcycle_s")
    if not n or not s:
        return None
    return 1e3 * s / n
