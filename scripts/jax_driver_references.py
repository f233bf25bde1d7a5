#!/usr/bin/env python3
"""The JAX package's runs of the three validation drivers' cases, built
as ``scripts/run_tgv.py``, ``scripts/run_cylinder.py`` and
``scripts/run_cavity.py`` build them (the same deck edits on
``SimulationParameters``, ``GLSNavierStokesSolver``, ``run_transient``
with an ``on_step`` or ``solve_steady``), at the sizes given, with the
Newton and Krylov iterations of every nonlinear solve counted.  The
reference that ``chip_smoke.py`` phase 16 and
``tests/test_torch_validation_drivers.py`` hold the PyTorch drivers
(``scripts/run_*_torch.py``) to.

    JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=<repo> \\
        python3 scripts/jax_driver_references.py tgv --n 48 --steps 3
    ... cylinder --order 2 --refine 4 --steps 10 --frequency 5
    ... cavity --n 8 --order 2

Without ``JAX_ENABLE_X64`` the run is float32 (the witness for cells per
adaptation, and for Krylov counts).  Prints per step t and KE, enstrophy
and the resolved dissipation (TGV) or the force on the cylinder (the
cylinder), the cells after each adaptation, each solve's counts, and the
totals; the cavity prints the centerline u at the lattice nodes'
interpolation to Ghia's stations and its counts.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 6.283185307179586


def _quiet(prm):
    for blk in (prm.nonlinear_solver, prm.linear_solver):
        blk.verbosity = type(blk.verbosity)("quiet")


def tgv_prm(n: int, dt: float, t_end: float, precond: str = "auto"):
    """``scripts/run_tgv.py``'s parameters."""
    from softx_2020_200_tpu.core.parameters import SimulationParameters
    prm = SimulationParameters.from_file(
        os.path.join(ROOT, "examples", "tgv3d_re1600.prm"), dim=3)
    prm.simulation_control.output_frequency = 0
    prm.simulation_control.dt = dt
    prm.simulation_control.time_end = t_end
    prm.mesh.grid_arguments = f"{n}, {n}, {n} : 0, 0, 0 : {L}, {L}, {L} : true"
    prm.restart.checkpoint = False
    _quiet(prm)
    prm.linear_solver.preconditioner = precond
    return prm


def cylinder_prm(order: int, refine: int, dt: float, t_end: float,
                 max_level: int = 6, fraction: float = 0.15,
                 frequency: int | None = None):
    """``scripts/run_cylinder.py``'s parameters (its Q2 run's flags as
    defaults), with the Kelly frequency given."""
    from softx_2020_200_tpu.core.parameters import SimulationParameters
    prm = SimulationParameters.from_file(
        os.path.join(ROOT, "examples", "cylinder_re100.prm"), dim=2)
    prm.simulation_control.output_frequency = 0
    prm.simulation_control.dt = dt
    prm.simulation_control.time_end = t_end
    prm.mesh.initial_refinement = refine
    ma = prm.mesh_adaptation
    ma.max_refinement_level = max_level
    ma.fraction_refinement = fraction
    if frequency is not None:
        ma.frequency = frequency
    prm.fem.velocity_order = order
    prm.fem.pressure_order = order
    prm.forces.calculate_forces = False
    prm.restart.checkpoint = False
    _quiet(prm)
    return prm


def script_constant(script: str, name: str):
    """A literal assigned to ``name`` at the top level of
    ``scripts/<script>`` (read, not run: the JAX scripts run on import)."""
    with open(os.path.join(ROOT, "scripts", script)) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == name):
            return ast.literal_eval(node.value)
    raise KeyError(f"{script}: no {name}")


def cavity_prm(n: int, order: int, precond: str = "auto"):
    """``scripts/run_cavity.py``'s deck and parameters."""
    from softx_2020_200_tpu.core.parameters import SimulationParameters
    deck = script_constant("run_cavity.py", "DECK")
    prm = SimulationParameters.from_text(deck.format(n=n), dim=2)
    prm.linear_solver.preconditioner = precond
    prm.fem.velocity_order = order
    prm.fem.pressure_order = order
    return prm


def counted_solver(prm):
    """The JAX GLS solver with every nonlinear solve's (Newton, Krylov)
    appended to its ``solves``, its final residual to ``residuals`` and
    every adaptation's cells to ``cells``."""
    from softx_2020_200_tpu.solvers.base import GLSNavierStokesSolver

    class Counted(GLSNavierStokesSolver):
        def _newton(self, *args, **kwargs):
            res = super()._newton(*args, **kwargs)
            n = int(res.n_iterations)
            self.solves.append((n, int(res.linear_iters)))
            self.residuals.append(float(np.asarray(res.res_history)[n]))
            return res

        def refine_mesh_kelly(self, fields):
            out = super().refine_mesh_kelly(fields)
            self.cells.append(int(self.space.n_elements))
            return out

    s = Counted(prm)
    s.solves, s.cells, s.residuals = [], [], []
    return s


def run_tgv(prm):
    """(solver, rows of (t, KE, enstrophy, eps_resolved))."""
    from softx_2020_200_tpu.solvers import postprocessing as post
    s = counted_solver(prm)
    rows = []

    def on_step(solver, u, t):
        rows.append((t, float(post.kinetic_energy(solver.op, u)),
                     float(post.enstrophy(solver.op, u)),
                     float(post.ke_dissipation_rate(solver.op, u))))

    s.run_transient(on_step=on_step, verbose=False)
    return s, rows


def run_cylinder(prm):
    """(solver, rows of (t, Fx, Fy) on the cylinder)."""
    from softx_2020_200_tpu.solvers import postprocessing as post
    s = counted_solver(prm)
    rows = []

    def on_step(solver, u, t):
        f = np.asarray(post.forces_on_boundary(
            solver.op, u, solver.space.boundary_faces[3]))
        rows.append((t, float(f[0]), float(f[1])))

    s.run_transient(on_step=on_step, verbose=False)
    return s, rows


def run_cavity(prm):
    """(solver, Newton result, centerline (y, u_x))."""
    s = counted_solver(prm)
    u, res = s.solve_steady(verbose=False)
    un = np.asarray(u)
    nodes = np.asarray(s.space.nodes)
    sel = np.nonzero(np.abs(nodes[:, 0] - 0.5) < 1e-12)[0]
    order = np.argsort(nodes[sel, 1])
    return s, res, (nodes[sel[order], 1], un[sel[order], 0])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("case", choices=("tgv", "cylinder", "cavity"))
    parser.add_argument("--n", type=int, default=48)
    parser.add_argument("--order", type=int, default=2)
    parser.add_argument("--refine", type=int, default=4)
    parser.add_argument("--frequency", type=int)
    parser.add_argument("--dt", type=float)
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args(argv)
    import jax
    print(f"JAX {jax.__version__}, x64 {jax.config.jax_enable_x64}",
          flush=True)
    if args.case == "tgv":
        dt = args.dt or 0.02
        s, rows = run_tgv(tgv_prm(args.n, dt, args.steps * dt))
        for t, ke, en, eps in rows:
            print(f"t {t:.4f} KE {ke:.9e} enstrophy {en:.9e} eps "
                  f"{eps:.9e}")
    elif args.case == "cylinder":
        dt = args.dt or 0.01
        s, rows = run_cylinder(cylinder_prm(
            args.order, args.refine, dt, args.steps * dt,
            frequency=args.frequency))
        for t, fx, fy in rows:
            print(f"t {t:.4f} force {fx:.9e} {fy:.9e} Cd {20 * fx:.7f} "
                  f"Cl {20 * fy:.7f}")
        print(f"cells after each adaptation: {s.cells}")
    else:
        ghia_y = script_constant("run_cavity.py", "GHIA_Y")
        ghia_u = script_constant("run_cavity.py", "GHIA_U")
        s, res, (y, ux) = run_cavity(cavity_prm(args.n, args.order))
        err = np.abs(np.interp(ghia_y, y, ux) - np.asarray(ghia_u))[1:-1]
        print("centerline u at Ghia's stations: " + " ".join(
            f"{v:.9e}" for v in np.interp(ghia_y, y, ux)))
        print(f"u_min {ux.min():.9e} max profile error {err.max():.9e} "
              f"rms {np.sqrt((err ** 2).mean()):.9e}")
    levels = getattr(s, "_mg_levels", None) or getattr(s, "mg_levels", None)
    print(f"preconditioner {s.precond_kind}"
          + (f" ({len(levels)} levels)" if levels else ""))
    tol = s.prm.nonlinear_solver.tolerance
    for i, ((n, k), r) in enumerate(zip(s.solves, s.residuals), start=1):
        print(f"solve {i}: {n} Newton, {k} Krylov iterations, final "
              f"residual {r:.4e}{' (above tolerance)' if r > tol else ''}")
    n = sum(a for a, _ in s.solves)
    k = sum(b for _, b in s.solves)
    print(f"total: {len(s.solves)} solves, {n} Newton, {k} Krylov "
          f"iterations, {k / max(n, 1):.4f} per Newton iteration")
    return 0


if __name__ == "__main__":
    sys.exit(main())
