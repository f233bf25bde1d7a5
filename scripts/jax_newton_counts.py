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
prints (forces, KE and enstrophy) is printed too.  Every nonlinear solve
is counted: a BDF step, each SDIRK stage, a steady solve.  A
pseudo-transient continuation solve (``solver = pseudo_transient``)
prints its pseudo-steps and their Krylov iterations as a ``PTC`` line.
``chip_smoke.py`` holds the PyTorch package's counts against the totals
this prints.

``--pallas-interpret`` runs a GLS deck's operator through the JAX
package's Pallas kernels in interpret mode (``enable_pallas(interpret=
True)``) with the deck's ``jacobian state precision``: how the JAX
package computes a bf16 Jacobian state on a CPU (its CPU path otherwise
ignores the key).  ``chip_smoke.py`` holds the bf16 Taylor-Couette run's
Newton count against the count this prints.

``--frozen-tau`` sets ``stabilization.frozen_tau_jacobian`` (not a deck
key): the Jacobian, and the element matrices of additive Schwarz, with
the stabilization parameter frozen, which is the linearization the
PyTorch package's CUDA kernels compute.
"""

import sys

import numpy as np

from softx_2020_200_tpu.core.parameters import SimulationParameters


def main(deck: str, dim: int, solver: str = "gls",
         pallas_interpret: bool = False, frozen_tau: bool = False) -> None:
    if solver == "gd":
        from softx_2020_200_tpu.solvers.gd import GDNavierStokesSolver as cls
    else:
        from softx_2020_200_tpu.solvers.base import \
            GLSNavierStokesSolver as cls
    total = {"solves": 0, "newton": 0, "krylov": 0}

    def record(res, what="Newton"):
        total["solves"] += 1
        total["newton"] += int(res.n_iterations)
        total["krylov"] += int(res.linear_iters)
        hist = np.asarray(res.res_history)
        hist = " ".join(f"{r:.4e}" for r in hist[~np.isnan(hist)])
        print(f"solve {total['solves']}: {int(res.n_iterations)} {what}, "
              f"{int(res.linear_iters)} Krylov iterations, residuals "
              f"{hist}", flush=True)

    newton = cls._newton

    def counted(self, *args, **kwargs):
        res = newton(self, *args, **kwargs)
        record(res)
        return res

    cls._newton = counted
    if hasattr(cls, "solve_steady_ptc"):
        ptc = cls.solve_steady_ptc

        def counted_ptc(self, *args, **kwargs):
            res = ptc(self, *args, **kwargs)
            record(res, "PTC steps")
            print(f"PTC: {int(res.n_iterations)} pseudo-steps, "
                  f"{int(res.linear_iters)} Krylov iterations, steady "
                  f"residual {float(res.res_history[int(res.n_iterations)]):.4e}",
                  flush=True)
            return res

        cls.solve_steady_ptc = counted_ptc
    prm = SimulationParameters.from_file(deck, dim=dim)
    if frozen_tau:
        prm.stabilization.frozen_tau_jacobian = True
        print("frozen tau Jacobian", flush=True)
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
    flags = ("--pallas-interpret", "--frozen-tau")
    args = [a for a in sys.argv[1:] if a not in flags]
    main(args[0], int(args[1]), *args[2:3],
         pallas_interpret=flags[0] in sys.argv[1:],
         frozen_tau=flags[1] in sys.argv[1:])
