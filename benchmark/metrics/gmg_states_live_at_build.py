"""Multigrid preconditioner states alive at each build in the traced
window: the states alive just after each build, the new one included,
over the builds (``gmg_states_live``, ``gmg_builds`` in
``solver.stats``; ``softx_2020_200_tpu_torch/core/spans.py``).  1 where
each Newton iteration's state is freed before the next is built; above
1 where a state outlives its Newton iteration."""


def read(ctx):
    n, live = ctx.stats.get("gmg_builds"), ctx.stats.get("gmg_states_live")
    if not n or live is None:
        return None
    return live / n
