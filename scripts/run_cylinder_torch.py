#!/usr/bin/env python3
"""Flow past a cylinder at Re 100 (Schaefer-Turek 2D-2, BASELINE config
#3) through the PyTorch package: ``examples/cylinder_re100.prm``,
transient BDF2 with Kelly adaptation on the forest, the force on the
cylinder every step, then the mean and peak drag coefficient, the lift
amplitude and the Strouhal number.

    python scripts/run_cylinder_torch.py --workdir W     # Q2, to t = 7
    python scripts/run_cylinder_torch.py --workdir W --resume
    python scripts/run_cylinder_torch.py --order 2 --refine 0 --t-end 0.04 \\
        --frequency 2 --device cpu --dtype float64 --out /tmp/f.dat

The counterpart of ``scripts/run_cylinder.py`` with the flags of its Q2
run as defaults (``CYL_ORDER=2 CYL_REFINE=4 CYL_MAXLEVEL=6
CYL_FRAC=0.15 CYL_T=7.0 CYL_DT=0.01``; the deck's Kelly every 50 steps
and 30,000 cells at most): the same deck edits (no field output, quiet
solvers, no force table: the force on boundary 3 is sampled after every
step) and the same analysis over the last 40 % of the steps, with
C = 2 F / (rho U^2 D), U = 1, D = 0.1.  Reference band for the confined
benchmark: Cd_max 3.22-3.24, Cl' ~1.0, St 0.295-0.305.

The deck's own checkpoint stays (every 100 steps, in ``--workdir``);
``--resume`` restarts from it, keeps the series of ``--out`` up to the
checkpoint's time and goes on, so that a run can be made in legs.  The
card's name and power limit are printed first; every ``--every`` steps a
line with t, Cd and Cl, the cells and DoF (after that step's
adaptation), the Newton and FGMRES iterations since the last line, the
solves above tolerance, the multigrid evictions to block-Jacobi and the
host seconds of the adaptation's timer sections (``kelly_estimate``,
``refine``, ``setup``, ``transfer``); one JSON line at the end.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
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

DECK = os.path.join(ROOT, "examples", "cylinder_re100.prm")
CYLINDER = 3
DIAMETER = 0.1
ADAPT_SECTIONS = ("kelly_estimate", "refine", "setup", "transfer")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--order", type=int, default=2,
                        help="velocity and pressure order")
    parser.add_argument("--refine", type=int, default=4,
                        help="initial refinement")
    parser.add_argument("--max-level", type=int, default=6,
                        help="max refinement level (the deck's: 5)")
    parser.add_argument("--fraction", type=float, default=0.15,
                        help="Kelly refinement fraction (the deck's: 0.12)")
    parser.add_argument("--max-elements", type=int,
                        help="element budget (the deck's: 30000)")
    parser.add_argument("--frequency", type=int,
                        help="steps between adaptations (the deck's: 50)")
    parser.add_argument("--dt", type=float, default=0.01)
    parser.add_argument("--t-end", type=float, default=7.0)
    parser.add_argument("--every", type=int, default=50,
                        help="steps between progress lines")
    parser.add_argument("--workdir", help="where the checkpoint goes (a "
                        "temporary directory by default)")
    parser.add_argument("--checkpoint-every", type=int,
                        help="steps between checkpoints (the deck's: 100)")
    parser.add_argument("--resume", action="store_true",
                        help="restart from the checkpoint in --workdir")
    parser.add_argument("--out", default=os.path.join(
        ROOT, "out_validation", "cylinder_forces.dat"), help="the series file")
    torch_driver.add_device_args(parser)
    return parser.parse_args(argv)


def build_prm(args, workdir: str) -> SimulationParameters:
    """The deck with ``scripts/run_cylinder.py``'s edits; the checkpoint
    kept, in ``workdir``."""
    prm = SimulationParameters.from_file(DECK, dim=2)
    sc = prm.simulation_control
    sc.output_frequency = 0
    sc.dt = args.dt
    sc.time_end = args.t_end
    sc.output_path = workdir.rstrip("/") + "/"
    prm.mesh.initial_refinement = args.refine
    ma = prm.mesh_adaptation
    ma.max_refinement_level = args.max_level
    ma.fraction_refinement = args.fraction
    if args.max_elements is not None:
        ma.max_number_elements = args.max_elements
    if args.frequency is not None:
        ma.frequency = args.frequency
    prm.fem.velocity_order = args.order
    prm.fem.pressure_order = args.order
    prm.forces.calculate_forces = False       # sampled in on_step
    if args.checkpoint_every is not None:
        prm.restart.frequency = args.checkpoint_every
    prm.restart.restart = bool(args.resume)
    for blk in (prm.nonlinear_solver, prm.linear_solver):
        blk.verbosity = type(blk.verbosity)("quiet")
    return prm


def analyse(series) -> dict:
    """Cd_mean, Cd_max, the Cl amplitude and the Strouhal number over the
    last 40 % of the (t, Fx, Fy) rows; St from the mean period between
    upward crossings of Cl through its mean (NaN with fewer than two)."""
    arr = np.asarray(series, dtype=float)
    tail = arr[int(0.6 * len(arr)):]
    cd, cl = 2 * tail[:, 1] / DIAMETER, 2 * tail[:, 2] / DIAMETER
    sign = np.sign(cl - cl.mean())
    crossings = tail[:-1, 0][np.diff(sign) > 0]
    st = float("nan")
    if len(crossings) >= 2:
        st = DIAMETER / float(np.mean(np.diff(crossings)))   # U = 1
    return {"Cd_mean": float(cd.mean()), "Cd_max": float(cd.max()),
            "Cl_amp": float((cl.max() - cl.min()) / 2), "St": st}


def write_series(path: str, series) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savetxt(path, np.asarray(series, dtype=float), header="t Fx Fy")


def run(args) -> dict:
    """Build the solver (from the checkpoint with ``--resume``), run the
    BDF2 loop with its adaptations, write the series; returns the summary
    (the series under ``series``, the cells after each adaptation under
    ``adaptations``)."""
    if args.resume and not args.workdir:
        raise SystemExit("--resume needs the --workdir of the first leg")
    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        workdir = args.workdir or tmp
        os.makedirs(workdir, exist_ok=True)
        return _run(args, workdir, cuda)


def _run(args, workdir: str, cuda: bool) -> dict:
    t0 = time.perf_counter()
    s = GLSNavierStokesSolver(build_prm(args, workdir), device=args.device,
                              dtype=torch_driver.DTYPES[args.dtype])
    print(f"elements={s.space.n_elements} dofs={s.space.n_dofs(3)} "
          f"preconditioner={s.precond_kind} "
          f"setup {time.perf_counter() - t0:.1f} s", flush=True)
    earlier = []
    if args.resume and os.path.exists(args.out):
        earlier = [tuple(r) for r in np.loadtxt(args.out, ndmin=2)]
    series, lines, adaptations = [], [], []
    last = {"sections": {}, "first": True, "steps": 0}
    since = torch_driver.Since(s)
    refine = s.refine_mesh_kelly

    def refine_mesh_kelly(fields):
        out = refine(fields)
        adaptations.append({"t": s.control.time,
                            "cells": s.space.n_elements,
                            "dofs": s.space.n_dofs(3)})
        return out

    s.refine_mesh_kelly = refine_mesh_kelly
    t1 = time.perf_counter()

    def sections():
        return {k: s.timer.sections[k][0] if k in s.timer.sections else 0.0
                for k in ADAPT_SECTIONS}

    def on_step(solver, u, t):
        if last["first"]:
            # a resumed leg: the earlier leg's rows up to the checkpoint
            series.extend(r for r in earlier
                          if r[0] < t - 0.5 * solver.control.dt)
            last["first"], last["sections"] = False, sections()
        f = post.forces_on_boundary(solver.op, u,
                                    solver.space.boundary_faces[CYLINDER])
        fx, fy = (float(x) for x in f.cpu())
        series.append((t, fx, fy))
        cells = solver.space.n_elements
        last["steps"] += 1
        if len(series) % args.every == 0:
            d = since.step(solver)
            now = sections()
            adapt = {k: now[k] - last["sections"][k] for k in ADAPT_SECTIONS}
            last["sections"] = now
            cd, cl = 2 * fx / DIAMETER, 2 * fy / DIAMETER
            row = {"step": len(series), "t": t, "Cd": cd, "Cl": cl,
                   "cells": cells, "dofs": solver.space.n_dofs(3),
                   "wall_s": time.perf_counter() - t1,
                   "newton": d["newton"], "fgmres": d["fgmres"],
                   "above_tolerance": d["above_tolerance"],
                   "gmg_evictions": d["gmg_evictions"], "adapt_s": adapt,
                   "peak_gib": torch_driver.peak_gib(cuda)}
            lines.append(row)
            print(f"step {row['step']} t={t:.2f} Cd={cd:.4f} Cl={cl:.4f} "
                  f"cells {cells} dofs {row['dofs']} newton {row['newton']} "
                  f"fgmres {row['fgmres']} above tolerance "
                  f"{row['above_tolerance']} evictions "
                  f"{row['gmg_evictions']} adapt "
                  + " ".join(f"{k} {v:.2f}" for k, v in adapt.items())
                  + f" wall={row['wall_s']:.1f}s", flush=True)
            write_series(args.out, series)

    s.run_transient(on_step=on_step, verbose=False)
    wall = time.perf_counter() - t1
    write_series(args.out, series)
    st = s.stats
    steps = last["steps"]
    out = {"case": "cylinder_re100", "order": args.order,
           "refine": args.refine, "max_level": args.max_level,
           "fraction": args.fraction, "dt": args.dt, "t_end": args.t_end,
           "dtype": args.dtype, "resumed": bool(args.resume),
           **analyse(series),
           "ref": {"Cd_max": "3.22-3.24", "Cl_max": "~1.0",
                   "St": "0.295-0.305"},
           "cells": s.space.n_elements, "dofs": s.space.n_dofs(3),
           "adaptations": adaptations,
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
    return torch_driver.main("run_cylinder_torch", parse_args, run, argv)


if __name__ == "__main__":
    sys.exit(main())
