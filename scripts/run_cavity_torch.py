#!/usr/bin/env python3
"""Lid-driven cavity at Re 400 (BASELINE config #1) through the PyTorch
package: a steady GLS solve on an N^2 lattice, and the u profile on the
vertical centerline against Ghia, Ghia & Shin (1982).

    python scripts/run_cavity_torch.py                   # Q2, 256^2
    python scripts/run_cavity_torch.py --n 8 --device cpu --dtype float64 \\
        --out /tmp/c.dat

The counterpart of ``scripts/run_cavity.py`` with the flags of its Q2 run
as defaults (``CAV_N=256 CAV_ORDER=2``): its deck (steady, nu 0.0025, a
unit lid, Newton 1e-8, GMRES(60) to 1e-4, ``auto``: geometric multigrid,
p- then h-coarsening, with FGMRES) and its analysis (u on the line x =
0.5 from the lattice nodes there, linearly interpolated to Ghia's
stations; the largest and rms profile errors over the inner stations).
The centerline (y, u) goes to ``--out``.  The card's name and power
limit are printed first, then the cells, DoF and multigrid levels, and
one JSON line: Newton and linear iterations, the Newton residuals, the
solves above tolerance and the multigrid evictions, seconds per Newton
iteration, peak device memory, u_min and the profile errors.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(SCRIPTS)
sys.path[:0] = [ROOT, SCRIPTS]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_driver  # noqa: E402
from softx_2020_200_tpu_torch.core.parameters import \
    SimulationParameters  # noqa: E402
from softx_2020_200_tpu_torch.solvers.base import \
    GLSNavierStokesSolver  # noqa: E402

# Ghia, Ghia & Shin (1982), Re=400, u on the vertical centerline
GHIA_Y = [0.0, 0.0547, 0.0625, 0.0703, 0.1016, 0.1719, 0.2813, 0.4531,
          0.5, 0.6172, 0.7344, 0.8516, 0.9531, 0.9609, 0.9688, 0.9766,
          1.0]
GHIA_U = [0.0, -0.08186, -0.09266, -0.10338, -0.14612, -0.24299,
          -0.32726, -0.17119, -0.11477, 0.02135, 0.16256, 0.29093,
          0.55892, 0.61756, 0.68439, 0.75837, 1.0]

DECK = """
subsection simulation control
  set method = steady
  set output frequency = 0
end
subsection physical properties
  set kinematic viscosity = 0.0025
end
subsection mesh
  set type = dealii
  set grid type = subdivided_hyper_rectangle
  set grid arguments = {n}, {n} : 0, 0 : 1, 1 : true
end
subsection boundary conditions
  set number = 4
  subsection bc 0
    set id = 0
    set type = noslip
  end
  subsection bc 1
    set id = 1
    set type = noslip
  end
  subsection bc 2
    set id = 2
    set type = noslip
  end
  subsection bc 3
    set id = 3
    set type = function
    subsection u
      set Function expression = 1
    end
  end
end
subsection non-linear solver
  set verbosity = quiet
  set tolerance = 1e-8
  set max iterations = 20
end
subsection linear solver
  set verbosity = quiet
  set relative residual = 1e-4
  set minimum residual = 1e-11
  set max krylov vectors = 60
  set max iters = 6000
end
"""


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--n", type=int, default=256, help="cells per axis")
    parser.add_argument("--order", type=int, default=2,
                        help="velocity and pressure order")
    parser.add_argument("--preconditioner", default="auto")
    parser.add_argument("--out", default=os.path.join(
        ROOT, "out_validation", "cavity_centerline.dat"),
        help="the centerline file")
    torch_driver.add_device_args(parser)
    return parser.parse_args(argv)


def build_prm(args) -> SimulationParameters:
    """``scripts/run_cavity.py``'s deck and edits."""
    prm = SimulationParameters.from_text(DECK.format(n=args.n), dim=2)
    prm.linear_solver.preconditioner = args.preconditioner
    prm.fem.velocity_order = args.order
    prm.fem.pressure_order = args.order
    return prm


def centerline(nodes: np.ndarray, u: np.ndarray):
    """(y, u_x) at the nodes on x = 0.5, by increasing y."""
    sel = np.nonzero(np.abs(nodes[:, 0] - 0.5) < 1e-12)[0]
    order = np.argsort(nodes[sel, 1])
    return nodes[sel[order], 1], u[sel[order], 0]


def analyse(y, ux) -> dict:
    """u_min on the centerline, and the largest and rms differences from
    Ghia's u at their inner stations (linear interpolation along y)."""
    err = np.abs(np.interp(GHIA_Y, y, ux) - np.asarray(GHIA_U))[1:-1]
    return {"u_min": float(np.min(ux)), "ghia_u_min": -0.32726,
            "max_profile_err": float(err.max()),
            "rms_profile_err": float(np.sqrt((err ** 2).mean()))}


def run(args) -> dict:
    """Build the solver, solve, write the centerline; returns the summary
    (with the centerline's u under ``centerline_u``)."""
    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = GLSNavierStokesSolver(build_prm(args), device=args.device,
                              dtype=torch_driver.DTYPES[args.dtype])
    levels = len(s.mg_levels) if s._vcycle is not None else 1
    setup = time.perf_counter() - t0
    print(f"elements={s.space.n_elements} dofs={s.space.n_dofs(3)} "
          f"preconditioner={s.precond_kind} levels={levels} "
          f"setup {setup:.1f} s", flush=True)
    u, res = s.solve_steady(verbose=False)
    un = u.detach().cpu().double().numpy()
    wall = time.perf_counter() - t0
    y, ux = centerline(np.asarray(s.space.nodes), un)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savetxt(args.out, np.column_stack([y, ux]), header="y u")
    st = s.stats
    its = int(res.n_iterations)
    return {"case": "cavity_re400", "n": args.n, "order": args.order,
            "dtype": args.dtype, "cells": s.space.n_elements,
            "dofs": int(s.space.n_dofs(3)), "levels": levels,
            "newton_iters": its, "linear_iters": int(res.linear_iters),
            "final_residual": float(res.res_history[its]),
            "newton_residuals": [float(r) for r in res.res_history[:its + 1]],
            "solves_above_tolerance": st["solves_above_tolerance"],
            "gmg_evictions": s._gmg_strikes,
            "s_per_newton": st["newton_seconds"] / max(its, 1),
            "setup_s": setup, "wall_s": wall,
            "peak_gib": torch_driver.peak_gib(cuda),
            **analyse(y, ux), "centerline_file": args.out,
            "centerline_u": [float(v) for v in ux]}


def main(argv=None) -> int:
    return torch_driver.main("run_cavity_torch", parse_args, run, argv,
                             drop=("centerline_u",))


if __name__ == "__main__":
    sys.exit(main())
