"""MiB moved per Newton iteration in the traced window by the index
gathers of the transfers between a lattice's finest level and its Q1
p-level: the state's injection, the prolongation and the restriction,
rows and indices from shapes (``gather_bytes_transfer_p`` in
``solver.stats``; ``softx_2020_200_tpu_torch/core/spans.py``).  These
bytes are also part of ``gather_mib_per_newton``'s ``transfer``.  A
count, the same for every run of one seed."""


def read(ctx):
    n = ctx.stats.get("newton_iterations")
    total = ctx.stats.get("gather_bytes_transfer_p")
    if not n or not total:
        return None
    return total / 2 ** 20 / n
