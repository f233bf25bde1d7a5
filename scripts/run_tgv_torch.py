#!/usr/bin/env python3
"""Taylor-Green vortex at Re 1600 (BASELINE config #4) through the
PyTorch package: ``examples/tgv3d_re1600.prm`` on an N^3 periodic Q1
lattice, BDF2 to ``--t-end``, and its kinetic-energy dissipation curve
against the 512^3 spectral DNS (peak -dE/dt ~ 0.0122 near t ~ 9).

    python scripts/run_tgv_torch.py                  # 96^3, dt 0.02, t 12
    python scripts/run_tgv_torch.py --n 8 --t-end 0.06 --device cpu \\
        --dtype float64 --out /tmp/tgv8.dat

The counterpart of ``scripts/run_tgv.py`` with the flags of its 96^3 run
as defaults (``TGV_N=96 TGV_DT=0.02 TGV_T=12 TGV_PRECOND=auto``): the
same deck edits (no field output, quiet solvers, the flag's
preconditioner; ``auto`` is geometric multigrid on the lattice levels
96^3 -> 48^3 -> 24^3 -> 12^3 with FGMRES) and the same analysis.  The
series (t, KE, eps_resolved, eps_total) goes to ``--out``: eps_total =
-dE/dt by ``np.gradient`` of the KE series (what the DNS reports),
eps_resolved = nu <grad u : grad u>.  The card's name and power limit
are printed first; every ``--every`` steps a line with t, KE, the
resolved dissipation, the wall so far, the Newton and FGMRES iterations
since the last line, the solves above tolerance and the multigrid
evictions to block-Jacobi (``GMG stagnated``); one JSON line at the end.
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
from softx_2020_200_tpu_torch.solvers import \
    postprocessing as post  # noqa: E402
from softx_2020_200_tpu_torch.solvers.base import \
    GLSNavierStokesSolver  # noqa: E402

DECK = os.path.join(ROOT, "examples", "tgv3d_re1600.prm")
L = 6.283185307179586


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--n", type=int, default=96, help="cells per axis")
    parser.add_argument("--dt", type=float, default=0.02)
    parser.add_argument("--t-end", type=float, default=12.0)
    parser.add_argument("--preconditioner", default="auto")
    parser.add_argument("--every", type=int, default=25,
                        help="steps between progress lines")
    parser.add_argument("--out", default=os.path.join(
        ROOT, "out_validation", "tgv_series.dat"), help="the series file")
    torch_driver.add_device_args(parser)
    return parser.parse_args(argv)


def build_prm(args) -> SimulationParameters:
    """The deck with ``scripts/run_tgv.py``'s edits."""
    prm = SimulationParameters.from_file(DECK, dim=3)
    prm.simulation_control.output_frequency = 0
    prm.simulation_control.dt = args.dt
    prm.simulation_control.time_end = args.t_end
    n = args.n
    prm.mesh.grid_arguments = f"{n}, {n}, {n} : 0, 0, 0 : {L}, {L}, {L} : true"
    prm.restart.checkpoint = False
    for blk in (prm.nonlinear_solver, prm.linear_solver):
        blk.verbosity = type(blk.verbosity)("quiet")
    prm.linear_solver.preconditioner = args.preconditioner
    return prm


def dissipation(series) -> np.ndarray:
    """-dE/dt of the (t, KE, ...) rows, by ``np.gradient`` (NaN for a
    single row)."""
    arr = np.asarray(series, dtype=float)
    if len(arr) < 2:
        return np.full(len(arr), np.nan)
    return -np.gradient(arr[:, 1], arr[:, 0])


def analyse(series) -> dict:
    """Peak -dE/dt and its time, the peak resolved dissipation and its
    time, and the final KE, of (t, KE, eps_resolved) rows."""
    arr = np.asarray(series, dtype=float)
    dE = dissipation(arr)
    k, j = int(np.argmax(dE)), int(np.argmax(arr[:, 2]))
    return {"peak_dissipation": float(dE[k]), "t_peak": float(arr[k, 0]),
            "peak_resolved": float(arr[j, 2]),
            "t_peak_resolved": float(arr[j, 0]),
            "ke_final": float(arr[-1, 1])}


def write_series(path: str, series) -> None:
    arr = np.asarray(series, dtype=float)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savetxt(path, np.column_stack([arr, dissipation(arr)]),
               header="t KE eps_resolved eps_total")


def run(args, step_hook=None) -> dict:
    """Build the solver, run the BDF2 loop, write the series; returns the
    summary (with the series under ``series``).  ``step_hook(n)``, when
    given, is called at the end of step n's post-processing (the
    profiler's window, ``scripts/profile_torch_deck.py``)."""
    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = GLSNavierStokesSolver(build_prm(args), device=args.device,
                              dtype=torch_driver.DTYPES[args.dtype])
    levels = len(s.mg_levels) if s._vcycle is not None else 1
    print(f"elements={s.space.n_elements} dofs={s.space.n_dofs(4)} "
          f"kernel={'lattice' if s.op.layout is not None else 'element'} "
          f"preconditioner={s.precond_kind} levels={levels} "
          f"setup {time.perf_counter() - t0:.1f} s", flush=True)
    series, lines = [], []
    since = torch_driver.Since(s)
    t1 = time.perf_counter()

    def on_step(solver, u, t):
        ke = float(post.kinetic_energy(solver.op, u))
        eps = float(post.ke_dissipation_rate(solver.op, u))
        series.append((t, ke, eps))
        n = len(series)
        if n % args.every == 0:
            d = since.step(solver)
            row = {"step": n, "t": t, "ke": ke, "eps_resolved": eps,
                   "wall_s": time.perf_counter() - t1, "newton": d["newton"],
                   "fgmres": d["fgmres"],
                   "above_tolerance": d["above_tolerance"],
                   "gmg_evictions": d["gmg_evictions"]}
            lines.append(row)
            print(f"step {n} t={t:.2f} KE={ke:.6e} eps={eps:.6e} "
                  f"wall={row['wall_s']:.1f}s newton {row['newton']} "
                  f"fgmres {row['fgmres']} above tolerance "
                  f"{row['above_tolerance']} evictions "
                  f"{row['gmg_evictions']}", flush=True)
            write_series(args.out, series)
        if step_hook is not None:
            step_hook(n)

    s.run_transient(on_step=on_step, verbose=False)
    wall = time.perf_counter() - t1
    write_series(args.out, series)
    st = s.stats
    steps = len(series)
    out = {"case": "tgv_re1600", "n": args.n, "dt": args.dt,
           "t_end": args.t_end, "dtype": args.dtype,
           "cells": s.space.n_elements, "dofs": s.space.n_dofs(4),
           "levels": levels, "steps": steps, **analyse(series),
           "reference": 0.0122, "t_reference": 9.0,
           "newton_solves": st["newton_solves"],
           "newton_iterations": st["newton_iterations"],
           "fgmres_iterations": st["linear_iterations"],
           "solves_above_tolerance": st["solves_above_tolerance"],
           "gmg_evictions": s._gmg_strikes,
           "s_per_newton": st["newton_seconds"]
           / max(st["newton_iterations"], 1),
           "s_per_step": wall / max(steps, 1), "wall_s": wall,
           "peak_gib": torch_driver.peak_gib(cuda),
           "series_file": args.out, "progress": lines, "series": series}
    return out


def main(argv=None) -> int:
    return torch_driver.main("run_tgv_torch", parse_args, run, argv)


if __name__ == "__main__":
    sys.exit(main())
