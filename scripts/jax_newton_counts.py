#!/usr/bin/env python3
"""Newton and Krylov iteration counts of a deck run through the JAX
package, per nonlinear solve and in total (its apps print neither), with
each solve's Newton residual history.

    python3 chip_smoke.py --write-decks DIR && cd DIR &&
    JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=<repo> \\
        python3 <repo>/scripts/jax_newton_counts.py tgv32_gmg.prm 3
    ... python3 <repo>/scripts/jax_newton_counts.py gd_cavity_r8.prm 2 gd

The third argument picks the solver: ``gls`` (the default) or ``gd``.
The deck runs through the solver's own ``solve()``, so what the app
prints (forces, KE and enstrophy) is printed too.  ``chip_smoke.py``
holds the PyTorch package's FGMRES iterations per Newton iteration
against the total this prints.

``--pallas-interpret`` runs a GLS deck's operator through the JAX
package's Pallas kernels in interpret mode (``enable_pallas(interpret=
True)``) with the deck's ``jacobian state precision``: how the JAX
package computes a bf16 Jacobian state on a CPU (its CPU path otherwise
ignores the key).  ``chip_smoke.py`` holds the bf16 Taylor-Couette run's
Newton count against the count this prints.
"""

import sys

import numpy as np

from softx_2020_200_tpu.core.parameters import SimulationParameters


def main(deck: str, dim: int, solver: str = "gls",
         pallas_interpret: bool = False) -> None:
    if solver == "gd":
        from softx_2020_200_tpu.solvers.gd import GDNavierStokesSolver as cls
    else:
        from softx_2020_200_tpu.solvers.base import \
            GLSNavierStokesSolver as cls
    total = {"solves": 0, "newton": 0, "krylov": 0}

    def counting(step):
        def counted(self, *args, **kwargs):
            u, res = step(self, *args, **kwargs)
            total["solves"] += 1
            total["newton"] += int(res.n_iterations)
            total["krylov"] += int(res.linear_iters)
            hist = np.asarray(res.res_history)
            hist = " ".join(f"{r:.4e}" for r in hist[~np.isnan(hist)])
            print(f"solve {total['solves']}: {int(res.n_iterations)} Newton, "
                  f"{int(res.linear_iters)} Krylov iterations, residuals "
                  f"{hist}", flush=True)
            return u, res
        return counted

    cls.solve_transient_step = counting(cls.solve_transient_step)
    cls.solve_steady = counting(cls.solve_steady)
    prm = SimulationParameters.from_file(deck, dim=dim)
    s = cls(prm)
    if pallas_interpret:
        import jax.numpy as jnp
        bf16 = prm.linear_solver.jacobian_state_precision == "bf16"
        s.op.enable_pallas(interpret=True,
                           state_dtype=jnp.bfloat16 if bf16 else None)
        s._rejit()
        print(f"Pallas kernels in interpret mode, state "
              f"{'bf16' if bf16 else 'full precision'}", flush=True)
    levels = getattr(s, "_mg_levels", None) or getattr(s, "mg_levels", None)
    print(f"preconditioner {s.precond_kind}"
          + (f" ({len(levels)} levels)" if levels else ""), flush=True)
    s.solve()
    n = max(total["newton"], 1)
    print(f"total: {total['solves']} solves, {total['newton']} Newton, "
          f"{total['krylov']} Krylov iterations, "
          f"{total['krylov'] / n:.2f} per Newton iteration")


if __name__ == "__main__":
    flag = "--pallas-interpret"
    args = [a for a in sys.argv[1:] if a != flag]
    main(args[0], int(args[1]), *args[2:3],
         pallas_interpret=flag in sys.argv[1:])
