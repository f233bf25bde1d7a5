#!/usr/bin/env python3
"""BASELINE #2, the spatial and temporal convergence orders, through the
PyTorch package: the ladders of the JAX package's convergence tests
(``tests/test_mms_convergence.py``, ``tests/test_gd_solver.py``,
``tests/test_sdirk_l2proj.py``, ``tests/test_postprocessing.py``) on
their own decks, continued past the tests' sizes.

    python scripts/run_convergence_torch.py            # every ladder, full
    python scripts/run_convergence_torch.py --ladders q2,bdf3 --max-q2 64
    python scripts/run_convergence_torch.py --device cpu --dtype float64 \\
        --budget 600                                   # the f64 witness

Ladders (one table line per level):

- ``q1``, ``q2``: the trig MMS on the unit square (nu = 1, Q1 or Q2).
  The JAX test's levels go through the steady uniform-cycle loop
  (``solve()``; Q1 from refinement 3, Q2 from 2, two cycles), which
  leaves the lattice after cycle 0 (the uniform refinement keeps no
  lattice), so the later cycles run on the general-geometry operator
  with block-Jacobi.  Finer levels run as their own deck at that initial
  refinement (the lattice operator, lattice multigrid: p- then
  h-coarsening for Q2), from the last cycle's size (the overlap, where
  both routes must give the same L2) to ``--max-q1`` / ``--max-q2``
  cells per axis.
- ``gd``: the grad-div Taylor-Hood solver on the same MMS (Q2-Q1), one
  deck per refinement from 2 (the JAX test: 2 and 3) to ``--max-gd``
  cells per axis, velocity-block multigrid.
- ``tc``: Taylor-Couette on the curved shell (Q2, 12 base cells,
  block-Jacobi), refinements 1 and 2 as the JAX test, then 2 (the
  overlap), 3 and 4 with GMRES(1000) as ``chip_smoke.py`` phase 4 runs
  refinement 3; then 4 and 5 on the forest with forest multigrid;
  the torque on the inner and outer walls beside -4 pi nu B.
- ``bdf1``, ``bdf2``, ``bdf3``, ``sdirk2``, ``sdirk3``: the space-exact
  transient MMS (Q2, nu 0.1) to t = 0.5 through ``run_transient`` (BDF3
  with ``history_from_exact``), dt from 0.1 halved to ``--min-dt``, at
  each refinement of ``--time-refines``.

Each line: the L2 errors of velocity and pressure and their rates
against the ladder's previous level, Newton and Krylov iterations,
solves above tolerance, multigrid evictions, seconds per Newton
iteration, set-up and solve seconds, peak device memory and the
launches of each CUDA kernel (B1 ``gls_element``, B2 ``gls_lattice``,
B3 ``gd_lattice``).  In float32 every deck's Newton tolerance is
replaced by one float32 reaches (``F32_TOLERANCE``) and its linear
solves stop where float32 can (``F32_MIN_RESIDUAL``); float64 keeps the
decks' own.  ``--budget`` skips the levels of a ladder that would end
past that many seconds (estimated from the level before).  The rows go
to ``--out`` as JSON; the card's name and power limit are printed first
and one JSON summary line last.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(SCRIPTS)
sys.path[:0] = [ROOT, SCRIPTS]

import torch  # noqa: E402

import torch_driver  # noqa: E402
from softx_2020_200_tpu_torch.core.parameters import \
    SimulationParameters  # noqa: E402
from softx_2020_200_tpu_torch.solvers import \
    postprocessing as post  # noqa: E402
from softx_2020_200_tpu_torch.solvers.base import \
    GLSNavierStokesSolver  # noqa: E402
from softx_2020_200_tpu_torch.solvers.gd import \
    GDNavierStokesSolver  # noqa: E402

# The decks of the JAX package's tests, as they are there
# (tests/test_mms_convergence.py MMS_DECK, TRANSIENT_MMS_DECK, TC_DECK;
# tests/test_gd_solver.py BASE and the extra of
# test_gd_mms_spatial_convergence); tests/test_torch_convergence.py
# holds these copies equal to them.
MMS_DECK = """
subsection simulation control
  set method = steady
  set number mesh adapt = {cycles}
end
subsection physical properties
  set kinematic viscosity = 1.0
end
subsection FEM
  set velocity order = {order}
  set pressure order = {order}
end
subsection mesh
  set type = dealii
  set grid type = hyper_cube
  set grid arguments = 0 : 1 : true
  set initial refinement = {refine}
end
subsection mesh adaptation
  set type = uniform
end
subsection boundary conditions
  set number = 4
  subsection bc 0
    set id = 0
    set type = function
    subsection u
      set Function expression = sin(pi*x)^2 * sin(2*pi*y)
    end
    subsection v
      set Function expression = -sin(2*pi*x) * sin(pi*y)^2
    end
  end
  subsection bc 1
    set id = 1
    set type = function
    subsection u
      set Function expression = sin(pi*x)^2 * sin(2*pi*y)
    end
    subsection v
      set Function expression = -sin(2*pi*x) * sin(pi*y)^2
    end
  end
  subsection bc 2
    set id = 2
    set type = function
    subsection u
      set Function expression = sin(pi*x)^2 * sin(2*pi*y)
    end
    subsection v
      set Function expression = -sin(2*pi*x) * sin(pi*y)^2
    end
  end
  subsection bc 3
    set id = 3
    set type = function
    subsection u
      set Function expression = sin(pi*x)^2 * sin(2*pi*y)
    end
    subsection v
      set Function expression = -sin(2*pi*x) * sin(pi*y)^2
    end
  end
end
subsection source term
  set enable = true
  subsection xyz
    set Function expression = mms
  end
end
subsection analytical solution
  set enable = true
  set verbosity = quiet
  subsection uvwp
    set Function expression = sin(pi*x)^2 * sin(2*pi*y); -sin(2*pi*x) * sin(pi*y)^2; x^4 - y^4
  end
end
subsection non-linear solver
  set verbosity = quiet
  set tolerance = 1e-11
  set max iterations = 12
end
subsection linear solver
  set verbosity = quiet
  set relative residual = 1e-5
  set minimum residual = 1e-13
end
"""

TRANSIENT_MMS_DECK = """
subsection simulation control
  set method = {method}
  set time step = {dt}
  set time end = {tend}
end
subsection physical properties
  set kinematic viscosity = 0.1
end
subsection FEM
  set velocity order = 2
  set pressure order = 2
end
subsection mesh
  set type = dealii
  set grid type = hyper_cube
  set grid arguments = 0 : 1 : true
  set initial refinement = {refine}
end
subsection boundary conditions
  set number = 4
  subsection bc 0
    set id = 0
    set type = function
    subsection u
      set Function expression = exp(-t)*y*y
    end
  end
  subsection bc 1
    set id = 1
    set type = function
    subsection u
      set Function expression = exp(-t)*y*y
    end
  end
  subsection bc 2
    set id = 2
    set type = function
    subsection u
      set Function expression = exp(-t)*y*y
    end
  end
  subsection bc 3
    set id = 3
    set type = function
    subsection u
      set Function expression = exp(-t)*y*y
    end
  end
end
subsection initial conditions
  set type = nodal
  subsection uvwp
    set Function expression = y*y; 0; x
  end
end
subsection source term
  set enable = true
  subsection xyz
    set Function expression = mms
  end
end
subsection analytical solution
  set enable = true
  set verbosity = quiet
  subsection uvwp
    set Function expression = exp(-t)*y*y; 0; exp(-t)*x
  end
end
subsection non-linear solver
  set verbosity = quiet
  set tolerance = 1e-11
  set max iterations = 10
end
subsection linear solver
  set verbosity = quiet
  set relative residual = 1e-5
  set minimum residual = 1e-13
end
"""

TC_DECK = """
subsection simulation control
  set method = steady
end
subsection physical properties
  set kinematic viscosity = 1.0
end
subsection FEM
  set velocity order = 2
  set pressure order = 2
end
subsection mesh
  set type = dealii
  set grid type = hyper_shell
  set grid arguments = 0, 0 : 0.25 : 1 : 12 : true
  set initial refinement = {refine}
end
subsection boundary conditions
  set number = 2
  subsection bc 0
    set id = 0
    set type = function
    subsection u
      set Function expression = -y
    end
    subsection v
      set Function expression = x
    end
  end
  subsection bc 1
    set id = 1
    set type = noslip
  end
end
subsection analytical solution
  set enable = true
  set verbosity = quiet
  subsection uvwp
    set Function expression = -(-(0.25*0.25/(1-0.25*0.25))*y + (0.25*0.25/(1-0.25*0.25))*y/(x*x+y*y)); (-(0.25*0.25/(1-0.25*0.25))*x + (0.25*0.25/(1-0.25*0.25))*x/(x*x+y*y)); 0.00222222222222*(x*x+y*y) - 0.00444444444444*log(x*x+y*y) - 0.00222222222222/(x*x+y*y)
  end
end
subsection non-linear solver
  set verbosity = quiet
  set tolerance = 1e-10
  set max iterations = 10
end
subsection linear solver
  set verbosity = quiet
  set relative residual = 1e-5
  set minimum residual = 1e-12
end
"""

GD_BASE = """
subsection simulation control
  set method = steady
end
subsection physical properties
  set kinematic viscosity = {nu}
end
subsection FEM
  set pressure order = 1
end
subsection mesh
  set type = dealii
  set grid type = hyper_cube
  set grid arguments = 0 : 1 : true
  set initial refinement = {refine}
end
subsection non-linear solver
  set verbosity = quiet
  set tolerance = 1e-10
  set max iterations = 12
end
subsection linear solver
  set verbosity = quiet
  set relative residual = 1e-4
  set minimum residual = 1e-12
end
{extra}
"""

GD_MMS_EXTRA = """subsection boundary conditions
  set number = 4
  subsection bc 0
    set id = 0
    set type = function
    subsection u
      set Function expression = sin(pi*x)^2 * sin(2*pi*y)
    end
    subsection v
      set Function expression = -sin(2*pi*x) * sin(pi*y)^2
    end
  end
  subsection bc 1
    set id = 1
    set type = function
    subsection u
      set Function expression = sin(pi*x)^2 * sin(2*pi*y)
    end
    subsection v
      set Function expression = -sin(2*pi*x) * sin(pi*y)^2
    end
  end
  subsection bc 2
    set id = 2
    set type = function
    subsection u
      set Function expression = sin(pi*x)^2 * sin(2*pi*y)
    end
    subsection v
      set Function expression = -sin(2*pi*x) * sin(pi*y)^2
    end
  end
  subsection bc 3
    set id = 3
    set type = function
    subsection u
      set Function expression = sin(pi*x)^2 * sin(2*pi*y)
    end
    subsection v
      set Function expression = -sin(2*pi*x) * sin(pi*y)^2
    end
  end
end

subsection source term
  set enable = true
  subsection xyz
    set Function expression = mms
  end
end
subsection analytical solution
  set enable = true
  subsection uvwp
    set Function expression = sin(pi*x)^2 * sin(2*pi*y); -sin(2*pi*x) * sin(pi*y)^2; x^4 - y^4
  end
end
"""

SPATIAL = ("q1", "q2", "gd", "tc")
TEMPORAL = ("bdf1", "bdf2", "bdf3", "sdirk2", "sdirk3")
LADDERS = SPATIAL + TEMPORAL
KERNELS = {"gls_element": "B1", "gls_lattice": "B2", "gd_lattice": "B3"}

# The JAX tests' bounds on a ladder's rate at their sizes: (low, high)
# on the velocity (and the Q2 pressure), None where open
RATE_BOUNDS = {"q1": (1.8, None), "q2": (2.7, None),
               "q2_pressure": (1.7, None), "gd": (2.6, None),
               "tc": (2.3, None), "bdf1": (0.8, 1.3), "bdf2": (1.6, 3.6),
               "bdf3": (2.5, 4.6), "sdirk2": (1.6, 3.6)}
# Taylor-Couette: u_theta = A r + B / r; the torque on the inner wall is
# -4 pi nu B (tests/test_postprocessing.py::test_taylor_couette_torque)
TC_NU, TC_RI, TC_RO = 1.0, 0.25, 1.0
TC_TORQUE = -4.0 * math.pi * TC_NU * TC_RI ** 2 * TC_RO ** 2 / (
    TC_RO ** 2 - TC_RI ** 2)

# Newton tolerances that float32 reaches (the decks' 1e-11 and 1e-10 it
# does not; ROADMAP C4), per ladder; "time" for the five transient ones.
# The port on the CPU in float32 floors the Newton residual at 3.1e-6 on
# Q1 64^2, 6.4e-6 on Q2 32^2, 3.8e-6 on GD 16^2, 1.6e-6 on
# Taylor-Couette r2 (GMRES(1000), as chip_smoke.py phase 4's 1e-5) and
# near 2e-7 on the transient deck at 4^2 and dt 0.05; the iterate before
# the floor is 1e-5 or more.  Grad-div and the transient deck take a
# tolerance nearer their floor: at 3e-5 the grad-div pressure at 16^2
# stops 7.7 % off (the JAX package's float32 run too), at 1e-5 the
# transient BDF2 at 4^2 and dt 0.05 1 %.  A level whose floor lies above
# its tolerance (the finest spatial levels, BDF1 at 4^2 from dt 0.0125
# on) stops by Newton's stall guard and counts as a solve above
# tolerance: it measures the floor.
F32_TOLERANCE = {"q1": 3e-5, "q2": 3e-5, "gd": 5e-6, "tc": 1e-5,
                 "time": 3e-6}
# ... and each Newton step's linear solve stops there (the deck's
# "minimum residual", 1e-13 and 1e-12, raised): asked for less than
# float32 reaches, FGMRES with the multigrid preconditioner returns a
# step that grows the residual up to a thousandfold (ROADMAP C12; the
# transient deck at 4^2, dt 0.05: 4e-5 -> 1e-2 on the CPU, where
# block-Jacobi or this floor take the same step to 2e-7).  On the card
# the transient deck needs a tenth of its tolerance (at a hundredth 10 of
# SDIRK3's 15 solves at dt 0.1 stay above it, its error 8 % off) and the
# steady decks a hundredth (at a tenth the Taylor-Couette pressure at r1
# ends 1.4 % off, Q2 at 128^2 31 %, and grad-div stalls at 16^2).
F32_MIN_RESIDUAL = {"q1": 3e-7, "q2": 3e-7, "gd": 5e-8, "tc": 1e-7,
                    "time": 3e-7}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ladders", default=",".join(LADDERS),
                        help="comma-separated, of " + ", ".join(LADDERS))
    parser.add_argument("--max-q1", type=int, default=1024,
                        help="cells per axis of the finest Q1 MMS level")
    parser.add_argument("--max-q2", type=int, default=512)
    parser.add_argument("--max-gd", type=int, default=256)
    parser.add_argument("--max-tc", type=int, default=4,
                        help="finest Taylor-Couette refinement with "
                        "block-Jacobi")
    parser.add_argument("--tc-forest", default="4,5",
                        help="Taylor-Couette refinements on the forest "
                        "(empty: none)")
    parser.add_argument("--min-dt", type=float, default=0.00625)
    parser.add_argument("--time-refines", default="2,6",
                        help="refinements of the transient ladders")
    parser.add_argument("--budget", type=float, default=None,
                        help="seconds per ladder: skip the levels that "
                        "would end past it")
    parser.add_argument("--out", default=os.path.join(
        ROOT, "out_validation", "convergence.json"),
        help="the rows, as JSON")
    torch_driver.add_device_args(parser)
    return parser.parse_args(argv)


# ----------------------------------------------------------------------
# the levels of each ladder
# ----------------------------------------------------------------------
def levels(name: str, args, cycles: int = 2, tc_jax=(1, 2),
           t_end: float = 0.5) -> list[dict]:
    """The levels of ladder ``name``, in order: each a dict with its
    ``label``, ``route``, ``sequence`` (rates are taken between
    consecutive levels of one sequence), the deck's arguments and, for
    an overlap level (another route to the level before it, which takes
    no rate), the label of the level it ``repeats``.  The keywords are
    the JAX tests' (uniform cycles of the MMS ladders, Taylor-Couette's
    refinements, the transient end time); the tests reduce them."""
    out = []
    if name in ("q1", "q2"):
        order, refine = (1, 3) if name == "q1" else (2, 2)
        top = args.max_q1 if name == "q1" else args.max_q2
        for c in range(cycles + 1):
            out.append(dict(label=f"{2 ** (refine + c)}^2",
                            route=f"cycle {c}", sequence="h",
                            order=order, refine=refine,
                            cycles=cycles, cycle=c))
        r = refine + cycles
        while 2 ** r <= top:
            lv = dict(label=f"{2 ** r}^2", route="deck", sequence="h",
                      order=order, refine=r, cycles=0, cycle=0)
            if r == refine + cycles:
                lv["repeats"] = lv["label"]
            out.append(lv)
            r += 1
    elif name == "gd":
        r = 2
        while 2 ** r <= args.max_gd:
            out.append(dict(label=f"{2 ** r}^2", route="deck",
                            sequence="h", refine=r))
            r += 1
    elif name == "tc":
        for r in tc_jax:
            out.append(dict(label=f"r{r}", route="deck", sequence="h",
                            refine=r, krylov=None))
        for r in range(2, args.max_tc + 1):
            lv = dict(label=f"r{r}", route="deck GMRES(1000)",
                      sequence="h", refine=r, krylov=1000)
            if r == 2:
                lv["repeats"] = "r2"
            out.append(lv)
        for r in (int(x) for x in args.tc_forest.split(",") if x):
            out.append(dict(label=f"r{r} forest", route="forest GMG",
                            sequence="forest", refine=r, forest=True))
    else:
        for r in (int(x) for x in args.time_refines.split(",") if x):
            dt = 0.1
            while dt >= args.min_dt * (1 - 1e-9):
                out.append(dict(label=f"dt {dt:g} @ {2 ** r}^2",
                                route="run_transient", sequence=f"r{r}",
                                refine=r, dt=dt, tend=t_end))
                dt /= 2
    for lv in out:
        lv["ladder"] = name
        r = lv["refine"] + lv.get("cycle", 0)
        lv["size"] = (12 if name == "tc" else 1) * 4 ** r
    return out


# ----------------------------------------------------------------------
# measuring one level
# ----------------------------------------------------------------------
def _launches() -> dict:
    from softx_2020_200_tpu_torch.ops.gls_kernel import GLSElementKernel
    from softx_2020_200_tpu_torch.ops.lattice_gd_kernel import \
        LatticeGDKernel
    from softx_2020_200_tpu_torch.ops.lattice_kernel import \
        LatticeGLSKernel
    return {"gls_element": GLSElementKernel.launches,
            "gls_lattice": LatticeGLSKernel.launches,
            "gd_lattice": LatticeGDKernel.launches}


class Meter:
    """What one level costs: the solver's counts (``torch_driver.Since``),
    the kernels' launches and the peak device memory since ``start``."""

    def __init__(self, cuda: bool):
        self.cuda = cuda

    def start(self, solver=None):
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.since = torch_driver.Since(solver)
        self.launched = _launches()
        self.t0 = time.perf_counter()

    def read(self, solver) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
        d = self.since.step(solver)
        now = _launches()
        its = max(d["newton"], 1)
        return {"newton": d["newton"], "krylov": d["fgmres"],
                "above_tolerance": d["above_tolerance"],
                "gmg_evictions": d["gmg_evictions"],
                "s_per_newton": d["newton_seconds"] / its,
                "wall_s": time.perf_counter() - self.t0,
                "peak_gib": torch_driver.peak_gib(self.cuda),
                "launches": {k: now[k] - self.launched[k] for k in now}}


def _prm(text: str, args, key: str):
    """The deck, with float32's Newton tolerance and linear floor (of
    ladder ``key``) unless float64, and its tables and fields (none in
    float64 either) written to the ladder's scratch directory."""
    prm = SimulationParameters.from_text(text, dim=2)
    if args.dtype != "float64":
        prm.nonlinear_solver.tolerance = F32_TOLERANCE[key]
        prm.linear_solver.minimum_residual = F32_MIN_RESIDUAL[key]
    sc = prm.simulation_control
    sc.output_frequency = 0
    sc.output_path = args.workdir + os.sep
    return prm


class _Timed:
    """Seconds spent in ``solver.setup`` (the mesh, the space, the
    operator and the multigrid levels), added up."""

    def __init__(self, solver):
        self.seconds = 0.0
        inner = solver.setup

        def setup(*a, **kw):
            t0 = time.perf_counter()
            try:
                return inner(*a, **kw)
            finally:
                self.seconds += time.perf_counter() - t0

        solver.setup = setup


def _mms_rows(group: list[dict], args, meter) -> list[dict]:
    """One solver over the uniform cycles of ``group`` (levels of one
    deck: the cycle levels, or one deck level), a row per cycle."""
    lv0 = group[0]
    dtype = torch_driver.DTYPES[args.dtype]
    t0 = time.perf_counter()
    prm = _prm(MMS_DECK.format(order=lv0["order"], refine=lv0["refine"],
                               cycles=lv0["cycles"]), args,
               lv0["ladder"])
    meter.start()
    s = GLSNavierStokesSolver(prm, device=args.device, dtype=dtype)
    setup = _Timed(s)
    setup.seconds = time.perf_counter() - t0
    rows = []

    def on_cycle(solver, u, t):
        lv = group[len(rows)]
        row = dict(lv, **meter.read(solver))
        row.update(cells=solver.space.n_elements,
                   dofs=int(solver.space.n_dofs(3)),
                   preconditioner=_precond(solver), setup_s=setup.seconds)
        row["error_velocity"], row["error_pressure"] = solver.l2_errors(u)
        rows.append(row)
        setup.seconds = 0.0
        meter.start(solver)

    s.solve(on_cycle=on_cycle)
    return rows


def _precond(solver) -> str:
    if getattr(solver, "_vcycle", None) is not None:
        return f"gmg ({len(solver.mg_levels)} levels)"
    return solver.precond_kind


def _gd_row(lv: dict, args, meter) -> dict:
    dtype = torch_driver.DTYPES[args.dtype]
    t0 = time.perf_counter()
    prm = _prm(GD_BASE.format(nu=1.0, refine=lv["refine"],
                              extra=GD_MMS_EXTRA), args,
               "gd")
    meter.start()
    s = GDNavierStokesSolver(prm, device=args.device, dtype=dtype)
    setup = time.perf_counter() - t0
    x, _ = s.solve_steady()
    row = dict(lv, **meter.read(s))
    row["error_velocity"], row["error_pressure"] = s.l2_errors(x)
    row.update(cells=s.op.space_v.n_elements, dofs=int(s.op.n_dofs),
               preconditioner=s.prm.linear_solver.resolved_preconditioner(),
               setup_s=setup)
    return row


def _tc_deck(lv: dict, args):
    prm = _prm(TC_DECK.format(refine=lv["refine"]), args,
               "tc")
    ls = prm.linear_solver
    if lv.get("krylov"):
        ls.max_krylov_vectors = lv["krylov"]
        ls.max_iters = 20000
    if lv.get("forest"):
        # chip_smoke.py tc_forest_r5.prm: the forest (Kelly, no
        # adaptation cycle) and its multigrid, the Q2 -> Q1 p-level first
        prm.mesh_adaptation.type = "kelly"
        ls.preconditioner = "gmg"
        ls.max_iters = 20000
    return prm


def _tc_row(lv: dict, args, meter) -> dict:
    dtype = torch_driver.DTYPES[args.dtype]
    t0 = time.perf_counter()
    prm = _tc_deck(lv, args)
    meter.start()
    s = GLSNavierStokesSolver(prm, device=args.device, dtype=dtype)
    setup = time.perf_counter() - t0
    row = dict(lv, cells=s.space.n_elements, dofs=int(s.space.n_dofs(3)),
               preconditioner=_precond(s), setup_s=setup)
    u, res = s.solve_steady(verbose=False)
    row.update(meter.read(s))
    its = int(res.n_iterations)
    row["residuals"] = [float(r) for r in res.res_history[:its + 1]]
    row["error_velocity"], row["error_pressure"] = s.l2_errors(u)
    faces = s.space.boundary_faces
    row["torque_inner"], row["torque_outer"] = (
        float(post.torques_on_boundary(s.op, u, faces[b],
                                       center=[0.0, 0.0])[0])
        for b in (0, 1))
    return row


def _time_row(lv: dict, args, meter) -> dict:
    dtype = torch_driver.DTYPES[args.dtype]
    t0 = time.perf_counter()
    prm = _prm(TRANSIENT_MMS_DECK.format(
        method=lv["ladder"], dt=lv["dt"], tend=lv["tend"],
        refine=lv["refine"]),
        args, "time")
    meter.start()
    s = GLSNavierStokesSolver(prm, device=args.device, dtype=dtype)
    setup = time.perf_counter() - t0
    u = s.run_transient(verbose=False,
                        history_from_exact=lv["ladder"] == "bdf3")
    row = dict(lv, **meter.read(s))
    row["error_velocity"], row["error_pressure"] = s.l2_errors(
        u, t=s.control.time)
    row.update(cells=s.space.n_elements, dofs=int(s.space.n_dofs(3)),
               preconditioner=_precond(s), setup_s=setup,
               steps=s.control.iteration, t_end=s.control.time)
    return row


# ----------------------------------------------------------------------
# rates and the table
# ----------------------------------------------------------------------
def rate(prev: float, cur: float) -> float:
    return math.log2(prev / cur)


def _fmt(x, spec: str) -> str:
    return "—" if x is None else format(x, spec)


def line(row: dict) -> str:
    """One table line."""
    kern = " ".join(f"{KERNELS[k]} {n}" for k, n in row["launches"].items()
                    if n) or "no kernel"
    extra = ""
    if row.get("overlap_rel_diff") is not None:
        extra += f"  same level by {row['repeats']}: {row['overlap_rel_diff']:.2e}"
    if row.get("torque_inner") is not None:
        extra += (f"  torque inner {row['torque_inner']:.6f} outer "
                  f"{row['torque_outer']:.6f} (exact {TC_TORQUE:.6f})")
    peak = row.get("peak_gib")
    return (f"{row['ladder']:6s} {row['label']:16s} {row['route']:18s} "
            f"cells {row['cells']:8d} dofs {row['dofs']:8d}  "
            f"e_u {row['error_velocity']:.6e} "
            f"e_p {row['error_pressure']:.6e}  "
            f"rate_u {_fmt(row.get('rate_velocity'), '.3f')} "
            f"rate_p {_fmt(row.get('rate_pressure'), '.3f')}  "
            f"newton {row['newton']} krylov {row['krylov']} "
            f"above_tol {row['above_tolerance']} evictions "
            f"{row['gmg_evictions']}  s/newton {row['s_per_newton']:.4f}  "
            f"setup {row['setup_s']:.2f} s wall {row['wall_s']:.2f} s  "
            f"peak {_fmt(peak, '.3f')} GiB  {kern}  [{row['preconditioner']}]"
            + extra)


def _with_rates(row: dict, done: list[dict]) -> dict:
    """The row's rates against the last row of its sequence, or, for an
    overlap row, its relative difference from the level it repeats."""
    if "repeats" in row:
        twin = next(r for r in done if r["label"] == row["repeats"])
        row["overlap_rel_diff"] = abs(
            row["error_velocity"] / twin["error_velocity"] - 1)
        return row
    prev = [r for r in done if r["sequence"] == row["sequence"]]
    if prev:
        p = prev[-1]
        row["rate_velocity"] = rate(p["error_velocity"],
                                    row["error_velocity"])
        row["rate_pressure"] = rate(p["error_pressure"],
                                    row["error_pressure"])
    return row


def _estimate(lv: dict, last: dict) -> float:
    """Seconds a level is expected to take (for ``--budget``): the last
    level's, times the ratio of their cells and of their time steps."""
    steps = last.get("dt", 1.0) / lv.get("dt", 1.0)
    return last["wall_s"] * lv["size"] / last["size"] * steps


def run_ladder(name: str, args, emit=print, todo=None) -> list[dict]:
    """The rows of ladder ``name`` at the levels ``todo`` (by default
    ``levels(name, args)``), each emitted as a table line when it is
    done."""
    with tempfile.TemporaryDirectory() as workdir:
        args.workdir = workdir
        return _run_levels(name, args, emit,
                           levels(name, args) if todo is None else todo)


def _run_levels(name: str, args, emit, todo) -> list[dict]:
    meter = Meter(args.device == "cuda")
    done = []
    t0 = time.perf_counter()
    last = None
    while todo:
        lv = todo[0]
        if args.budget is not None and last is not None:
            left = args.budget - (time.perf_counter() - t0)
            if _estimate(lv, last) > left:
                for skipped in todo:
                    emit(f"{name:6s} {skipped['label']:16s} skipped: "
                         f"budget {args.budget:g} s")
                break
        if "cycles" in lv:
            group = [x for x in todo if x["refine"] == lv["refine"]
                     and x["route"].startswith("cycle") ==
                     lv["route"].startswith("cycle")]
            new = _mms_rows(group, args, meter)
        elif name == "gd":
            group, new = [lv], [_gd_row(lv, args, meter)]
        elif name == "tc":
            group, new = [lv], [_tc_row(lv, args, meter)]
        else:
            group, new = [lv], [_time_row(lv, args, meter)]
        for row in new:
            done.append(_with_rates(row, done))
            emit(line(row))
            last = row
        todo = todo[len(group):]
    return done


def run(args) -> dict:
    """Every ladder of ``--ladders``; returns the summary, with every row
    under ``rows`` (also written to ``--out``)."""
    names = [n for n in args.ladders.split(",") if n]
    bad = set(names) - set(LADDERS)
    if bad:
        raise SystemExit(f"unknown ladders {sorted(bad)}")
    rows, t0 = [], time.perf_counter()
    for name in names:
        print(f"-- {name}", flush=True)
        rows += run_ladder(name, args,
                           emit=lambda s: print(s, flush=True))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(rows, fh, indent=1)
    summary = {}
    for r in rows:
        summary.setdefault(r["ladder"], []).append(
            [r["label"], r["error_velocity"], r.get("rate_velocity")])
    return {"case": "convergence", "dtype": args.dtype,
            "ladders": summary, "wall_s": time.perf_counter() - t0,
            "out": args.out, "rows": rows}


def main(argv=None) -> int:
    return torch_driver.main("run_convergence_torch", parse_args, run, argv,
                             drop=("rows",))


if __name__ == "__main__":
    sys.exit(main())
