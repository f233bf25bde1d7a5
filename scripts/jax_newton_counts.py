#!/usr/bin/env python3
"""Newton and Krylov iteration counts of a transient deck run through the
JAX package, per time step and in total (its apps print neither).

    python3 chip_smoke.py --write-decks DIR && cd DIR &&
    JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=<repo> \\
        python3 <repo>/scripts/jax_newton_counts.py tgv32_gmg.prm 3

``chip_smoke.py`` holds the PyTorch package's FGMRES iterations per
Newton iteration against the total this prints.
"""

import sys

from softx_2020_200_tpu.core.parameters import SimulationParameters
from softx_2020_200_tpu.solvers import base


def main(deck: str, dim: int) -> None:
    total = {"solves": 0, "newton": 0, "krylov": 0}
    step = base.GLSNavierStokesSolver.solve_transient_step

    def counted(self, *args, **kwargs):
        u, res = step(self, *args, **kwargs)
        total["solves"] += 1
        total["newton"] += int(res.n_iterations)
        total["krylov"] += int(res.linear_iters)
        print(f"solve {total['solves']}: {int(res.n_iterations)} Newton, "
              f"{int(res.linear_iters)} Krylov iterations", flush=True)
        return u, res

    base.GLSNavierStokesSolver.solve_transient_step = counted
    solver = base.GLSNavierStokesSolver(
        SimulationParameters.from_file(deck, dim=dim))
    print(f"preconditioner {solver.precond_kind}", flush=True)
    solver.solve()
    n = max(total["newton"], 1)
    print(f"total: {total['solves']} solves, {total['newton']} Newton, "
          f"{total['krylov']} Krylov iterations, "
          f"{total['krylov'] / n:.2f} per Newton iteration")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
