#!/usr/bin/env python3
"""Smoke run of the PyTorch package (``softx_2020_200_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py                  # all phases, needs CUDA
    python3 chip_smoke.py --phases 2,3c    # only these (no contract line)
    python3 chip_smoke.py --parent DIR     # and time DIR's B1-B3 too
    python3 chip_smoke.py --write-decks D  # write the main-path decks

Phases (each prints its own lines; any failed check raises):

1. environment: card name and power limit, torch / CUDA / nvcc / triton
   versions;
2. build: ``nvcc`` compiles the GLS element kernel (B1,
   ``csrc/gls_element.cu``), the GLS lattice kernel (B2,
   ``csrc/gls_lattice.cu``) and the grad-div (GD) lattice kernel (B3,
   ``csrc/gd_lattice.cu``) of ``softx_2020_200_tpu_torch`` (and, with
   ``--parent``, the three of that checkout), one process each, in
   parallel; prints ptxas's registers and spills and fails on a spill in
   any B1, B2 or B3 variant; holds each variant's shared memory, threads
   and blocks per SM to the Python mirror the CPU tests check
   (``tile_config``);
3. B1 against its plain PyTorch version (primal, frozen-tau tangent,
   node-block probes) for Q1/Q2 in 2D/3D on non-affine geometry, without
   and with LSIC, on each route (STAGED; REGISTERS with each of its
   threads per element), with both load paths (TMA where E % 4 == 0,
   4-byte cp.async where it is not) and below one tile; 3b: the same at
   B1's main-path shapes, then times: the kernel, the other routes, and
   the plain version (and with ``--parent`` the parent's kernel through
   its own wrapper on the same inputs, ``ms_parent``); 3c: B2 the same
   way on parity lattices (both routes at Q1 with 2 points per axis), on
   a box and then a sheared lattice of the same size (the sheared one
   must stay STAGED, and its REGISTERS launch is refused), then at B2's
   main-path shapes and every multigrid level of phases 6 and 7, each
   timed; 3d: B3 (primal, exact tangent) against its plain version on
   every route (STAGED; REGISTERS in 2D) and both load paths, on bounded
   and periodic parity lattices with a ragged tail, with E % 4 == 0 and
   below one tile, and on a sheared 3D lattice (a full J^-1), then at its
   main-path shapes (2D 256^2, 3D 16^3 and 32^3) and 2D 128^2, each
   timed as B2 (with the parent's B3 through its own wrapper); in 3, 3b
   and 3c the tangent and the node blocks of B1 and B2 run with a bf16
   Jacobian state too (tangent_bf16, probe_bf16), held against their
   plain version on the same rounded state on every route, in rows that
   take TMA and in rows at a pitch that takes 4-byte cp.async, and timed
   beside the f32 ones at the main-path shapes;
4. main path, 2D steady, B1: Taylor-Couette (Q2 on a curved shell) at
   refinement 3 with block-Jacobi through ``gls_navier_stokes_2d``, every
   Newton solve under its tolerance (refinement 5 runs in phase 12);
5. main path, 3D transient, B2: the Taylor-Green vortex on a periodic
   32^3 Q1 box, BDF2, 3 steps, block-Jacobi, through
   ``gls_navier_stokes_3d``;
6. the same TGV deck with its own ``auto`` preconditioner: geometric
   multigrid on three lattice levels, every level on B2, with as many
   FGMRES iterations as the JAX package and no host reads beyond the
   solver loop's; one V-cycle is also applied alone with CUDA
   synchronisation made an error;
7. a Q2 lattice deck with multigrid (p-coarsening, then lattice halving):
   the golden MMS deck at refinement 8 (256^2 Q2 cells), every Newton
   solve under its tolerance;
8. main path of the GD solver, 2D steady, B3: the golden GD cavity at
   refinement 8 (256^2 Q2-Q1 cells) through ``gd_navier_stokes_2d`` with
   velocity-block multigrid (6 levels): forces, FGMRES count, host
   syncs, every solve converged;
9. GD, 3D transient, B3: the Taylor-Green example at 16^3 Q2-Q1 cells,
   2 BDF2 steps, through ``gd_navier_stokes_3d`` (3 multigrid levels);
10. the bf16 Jacobian state on the main path (``jacobian state
   precision = bf16``): Taylor-Couette r3 on B1 and TGV 32^3 with
   block-Jacobi and with multigrid on B2, each beside its f32 run: only
   the bf16 tangent and probe launch, the physics stays inside the f32
   phases' bounds, Newton is held to the f32 count + 1 (to the JAX
   package's bf16 count on the curved shell); and the distance between
   the bf16 and the f32 tangent at Taylor-Couette r3 and r5;
11. the solver options of decks without a forest, at the decks' full
   size: SDIRK2 on TGV 32^3 with GMG and SDIRK3 on the MMS deck at
   refinement 7 (B2), SDIRK2 on the GD TGV 16^3 (B3), pseudo-transient
   continuation on the lid-driven cavity at 256^2 (B2, GMG), phase 6's
   and phase 9's decks interrupted by a checkpoint and restarted in a
   second run (held to the uninterrupted runs), additive Schwarz on
   phases 4's and 5's decks (element matrices from nn*c tangent launches
   of B1 and B2 with one-hot directions); then the card's element
   matrices against the plain frozen-tau element matrices at TC r3,
   TGV 32^3 and 2D Q2 128^2, timed beside the node blocks;
12. Kelly adaptation on the forest, through the apps, every mesh and
   forest multigrid level on B1 (Q1 levels below a Q2 mesh with 3 Gauss
   points per axis): the cylinder at Re 100 as the example writes it but
   7 steps with Kelly after every one (cells after each adaptation, Cd
   and Cl per step), the same deck restarted on its forest after step 2,
   the lid-driven cavity at Re 400 with 3 Kelly cycles (cells, Newton and
   Krylov per cycle, the centerline u at Ghia's stations),
   Taylor-Couette r3 on the forest with forest GMG (the Q2 -> Q1
   p-level), the GD Kelly deck (plain torch)
   and the 3D sphere at its base mesh with one Kelly cycle; then B1 is
   compared with its plain version and timed at every (dim, degree,
   points per axis, E) those runs launched and phase 3b did not time, on
   the launching operator's own geometry and state;
13. the multi-device path, 4 shards on the one card through
   ``run_app(..., devices=[cuda:0] * 4)`` (B1 per shard at the
   shard-padded E, the coarse multigrid levels whole on B1): phase 7's
   MMS deck (Newton and FGMRES against the JAX package's 4-way run, L2
   per step against its f64 values and phase 7's run), phase 12's
   cylinder (the JAX cells, Cd and Cl against JAX f64 and phase 12's
   run) and its restart from 4 shards to 2, the golden restart decks at
   128^2 from 4 shards to 2 against the uninterrupted run, the golden GD
   MMS deck over 4 shards and 1 (plain torch); each run prints its
   shards' owned and ghost nodes, the bytes per refresh and its seconds
   per Newton iteration beside the 1-device run's; then B1 is compared
   and timed at every shard shape those runs launched.  ``--phases 13``
   runs phases 7 and 12 first; the cylinder over shards adapts after the
   BDF2 startup step too, as the JAX package's sharded loop does, and is
   held to that loop's 4-way run (its one-device loop adapts once less);
14. the bf16 operand build (``GLSOperator`` and ``GDOperator`` with
   ``dtype=torch.bfloat16``: every row, the direction, the tables and the
   output in bf16, float32 arithmetic inside): (a) each bf16-operand
   instance of B1 and B2 (primal, tangent, probe) and of B3 (primal,
   tangent) against its plain version on the card (the bf16 operands
   widened, the float32 plain kernel, the output rounded to bf16) within
   ``BF16OP_RTOL`` of scale, on every route, in rows that take TMA and in
   rows at a pitch that takes 4-byte cp.async, with E % 4 != 0 and below
   one tile, B1 on non-affine meshes, B2 on a box and a sheared lattice
   (whose REGISTERS launch is refused), B3 bounded, periodic and sheared;
   (b) each at full width (B2 TGV 32^3 and the 64^3 box, B1 TC r5 and 3D
   Q1 moved 32^3, B3 2D 256^2 and 3D 16^3), compared and timed beside the
   float32 and the bf16-state tangent, the plain version and the bound;
   (c) the bf16 operator's residual and tangent through gathers, kernel
   and assembly at TGV 32^3 (B2), TC r5 (B1) and the GD cavity at 256^2
   (B3), within ``BF16_OPERATOR_RTOL`` of the float32 operator, its launch
   counters showing one primal_bf16op and one tangent_bf16op launch;
   (d) the lattice matvec at the 64^3 box in three builds (float32,
   float32 with a bf16 state, bf16 operands): seconds per matvec and
   GDoF/s.  No deck selects the dtype, so these instances have no
   main-path launches.  ``--phases 14`` runs the build and this phase;
15. the sphere (BASELINE #5, ``examples/sphere_re100.prm``) at its own
   base mesh, initial refinement 2 (14,720 cells of 3D Q1 on the forest),
   with its Kelly cycles, through ``gls_navier_stokes_3d`` on B1 with
   forest GMG: the cells after each adaptation, Newton and FGMRES per
   solve and the GMG evictions against the JAX package's float32 run
   with tau frozen, every solve under its tolerance, the force on the
   sphere per cycle against its float64 run; then B1 is compared and
   timed at every shape the run launched;
16. the validation drivers (``scripts/run_cavity_torch.py``,
   ``run_tgv_torch.py``, ``run_cylinder_torch.py``) through their own
   ``run`` at full width for a short window: (a) the lid-driven cavity at
   Re 400, Q2 256^2 (789,507 DoF, B2, 6 GMG levels) in full, u_min and
   the largest profile error at Ghia's stations against the float64
   solution, Newton within 1 of the JAX package's chip run's 9; (b) the TGV at 48^3, 3
   BDF2 steps (B2, GMG on 3 lattice levels), KE and enstrophy per step
   against the JAX package's float64 run and FGMRES per Newton iteration
   within 1 of its float32 run; (c) the cylinder at Re 100 in Q2 from
   refinement 4 (6,912 cells, B1 with forest GMG and its Q1 p-level),
   10 steps with Kelly every 5, the cells after each adaptation against
   the JAX package's float32 run and Cd and Cl per step against its
   float64 run; no GMG eviction in any; then B1 at every shape the
   cylinder launched.

Phases 4-13, 15 and 16 hold their physics numbers against the JAX package
run on the CPU in float64 on the same decks (``JAX_REFERENCE`` below;
where float32 moves a count or a flagged cell, against its float32 run)
and check which kernel each deck launched. The line before the last
lists the kernels with their launch counts in the main-path runs (in
total and per shape and variant), errors, times (the kernel's, the plain
version's and, with ``--parent``, the parent's; ``ms_parent`` is null
without it) and bounds, each kernel's bf16-operand instances with their
own errors (``bf16op``) and, per shape, times and bounds; the last line
of standard output is the JSON contract line ``{"ok": true, "device":
{...}}``. Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))

# kernel against its plain version, both float32 on the card: max-abs
# error over the max-abs scale of the plain result, the bar the JAX
# package holds its TPU kernel to (tests/test_pallas_kernel.py)
KERNEL_RTOL = 5e-6

# The H100 SXM's published peaks (NVIDIA data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores.  A kernel's bound is the
# larger of its bytes (each input read once, each output written once)
# over the first and its operations over the second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# The main-path decks: the repo's examples, cut to size.
#
# Taylor-Couette with block-Jacobi runs at refinement 3 (768 Q2 cells),
# where GMRES converges the Newton solve and the L2 errors are held
# against the JAX package.  At refinement 5 (12,288 cells, 149,760 DoF)
# block-Jacobi does not: in the JAX package on the CPU in f64 it stalls
# Newton at residual 4.0e-2 (C3).  On the forest its multigrid converges
# refinement 5 in the JAX package in f64 (2 Newton, 1,893 FGMRES), but
# not in float32 within the script's time, there or on the card
# (tc_forest_r5.prm, ROADMAP C3); the block-Jacobi refinement-5 deck
# stays for phase 10's tangent distance.
def _tc(refinement: int):
    return [("initial refinement", str(refinement)),
            ("number mesh adapt", "0"),
            ("subsection analytical solution", "set verbosity = verbose"),
            ("subsection simulation control", "set log precision = 8"),
            ("subsection linear solver", "set preconditioner = block_jacobi")]


# Newton tolerances that float32 reaches (ROADMAP C4).  In float32 the
# decks' 1e-10 is out of reach, in the JAX package as in the port (both
# on the CPU in float32, at reduced sizes: the same Newton and Krylov
# counts, residuals floored at 3.8e-6 on Taylor-Couette r3 and near 1e-6
# on the MMS deck at refinement 6).  Taylor-Couette r3 also takes
# GMRES(1000), as r5 does: GMRES(100) with block-Jacobi stops each linear
# solve at its 1,000-iteration cap, in float64 too, and a Newton iterate
# that such steps bring under 1e-5 is still 1-2 % off in its L2 errors
# (float64 and float32 alike); with GMRES(1000) two Newton iterations
# reach 3.9e-6 and the L2 errors of the converged solve (the port on the
# CPU in float32).  The JAX references below were taken on these decks.
TC_TOLERANCE = "1e-5"
MMS_TOLERANCE = "1e-5"
# a deck's Newton residuals, one line each
_VERBOSE_NEWTON = ("subsection non-linear solver", "set verbosity = verbose")
# the bf16 Jacobian state (phase 10)
_BF16_STATE = ("subsection linear solver",
               "set jacobian state precision = bf16")


DECKS = {
    "taylor_couette_r3.prm": ("examples/taylor_couette_mms.prm", _tc(3) + [
        ("subsection linear solver", "set max krylov vectors = 1000"),
        ("subsection linear solver", "set max iters = 20000"),
        ("tolerance", TC_TOLERANCE), _VERBOSE_NEWTON]),
    "taylor_couette_r5.prm": ("examples/taylor_couette_mms.prm", _tc(5) + [
        ("subsection linear solver", "set max krylov vectors = 1000"),
        ("subsection linear solver", "set max iters = 20000"),
        ("max iterations", "4"),
    ]),
    "tgv32_3steps.prm": ("examples/tgv3d_re1600.prm", [
        ("time end", "0.15"),
        ("subsection linear solver", "set preconditioner = block_jacobi"),
    ]),
    # the same three steps with the deck's own `auto` preconditioner:
    # geometric multigrid on the lattices 32^3 -> 16^3 -> 8^3
    "tgv32_gmg.prm": ("examples/tgv3d_re1600.prm", [("time end", "0.15")]),
    # the golden Q2 MMS deck at refinement 8 (256^2 Q2 cells, 789,507
    # DoF), the largest whose JAX CPU f64 run takes minutes (6 minutes on
    # 8 cores; refinement 7 took 2): p-coarsening to Q1, then lattice
    # halving (256^2 -> 128^2 -> 64^2 -> 32^2 -> 16^2)
    "mms_q2_r8.prm": ("tests/golden/mms_bdf2.prm", [
        ("initial refinement", "8"),
        ("log precision", "8"),
        ("subsection analytical solution", "set verbosity = verbose"),
        ("text", ("subsection test\n  set enable = true",
                  "subsection test\n  set enable = false")),
        ("tolerance", MMS_TOLERANCE),
        ("text", ("set verbosity      = quiet\n  set tolerance",
                  "set verbosity      = verbose\n  set tolerance")),
    ]),
    # the golden grad-div (GD) cavity at refinement 8 (256^2 Q2-Q1
    # cells, 592,387 DoF), the largest whose JAX CPU f64 run converges
    # in minutes; `auto` -> velocity-block GMG, 256^2 -> ... -> 8^2.
    # Newton stops at 1e-4, not the golden 1e-9: float32 residuals at
    # this size floor near 1e-5, and the f64 run passes 1e-4 after its
    # second iteration (1.6 -> 1.4e-3 -> 7.2e-6)
    "gd_cavity_r8.prm": ("tests/golden/gd_cavity.prm", [
        ("initial refinement", "8"),
        ("tolerance", "1e-4"),
        ("log precision", "8"),
        ("text", ("subsection test\n  set enable = true",
                  "subsection test\n  set enable = false")),
    ]),
    # the TGV example through the GD solver at 16^3 Q2-Q1 cells (102,400
    # DoF), 2 BDF2 steps (3 solves with the startup sub-step): `auto`
    # -> GMG 16^3 -> 8^3 -> 4^3.  Newton stops at 1e-5, not the
    # example's 1e-6, which float32 does not reach on this deck (on an
    # H100 its 3 solves took 18 Newton and 13,201 FGMRES iterations,
    # none converged); the f64 run takes the same iterates either way
    # (each solve 2e-1..3e-1 -> 1e-4..3e-4 -> 1e-7..3e-7)
    "tgv16_gd.prm": ("examples/tgv3d_re1600.prm", [
        ("grid arguments", "16, 16, 16 : 0, 0, 0 : 6.283185307179586, "
         "6.283185307179586, 6.283185307179586 : true"),
        ("time end", "0.1"),
        ("tolerance", "1e-5"),
    ]),
}
# phase 10: the decks of phases 4-6 with the bf16 Jacobian state, each
# run beside its float32 one
BF16_DECKS = {"taylor_couette_r3.prm": 2, "tgv32_3steps.prm": 3,
              "tgv32_gmg.prm": 3}
for _name in BF16_DECKS:
    _src, _edits = DECKS[_name]
    DECKS[_name.replace(".prm", "_bf16.prm")] = (_src, _edits + [_BF16_STATE])


# phase 11: the solver options of decks without a forest (SDIRK,
# pseudo-transient continuation, checkpoint/restart, additive Schwarz)
def _edited(name: str, *, drop=(), add=()):
    """DECKS[name]'s source and edits, without the edits whose key is in
    ``drop``, then ``add``."""
    src, edits = DECKS[name]
    return src, [e for e in edits if e[0] not in drop] + list(add)


def _restart(checkpoint: bool, restart: bool, frequency: int):
    """A restart subsection, put before the non-linear solver's."""
    head = "subsection non-linear solver"
    return ("text", (head, f"subsection restart\n  set checkpoint = "
                     f"{str(checkpoint).lower()}\n  set restart    = "
                     f"{str(restart).lower()}\n  set frequency  = "
                     f"{frequency}\n  set filename   = restart\nend\n{head}"))


_AS = ("subsection linear solver", "set preconditioner = additive_schwarz")
_BJ = ("subsection linear solver", "set preconditioner = block_jacobi")
DECKS.update({
    # TGV 32^3 with 'auto' (GMG), SDIRK2: 3 steps of 2 stages, Newton to
    # the example's 1e-6.  The JAX package in float32 reaches it in two
    # iterations per stage (residuals below), so the card must too
    "tgv32_sdirk2.prm": _edited("tgv32_gmg.prm",
                                add=[("method", "sdirk2"), _VERBOSE_NEWTON]),
    # the golden MMS deck at refinement 7 (128^2 Q2 cells, 198,147 DoF),
    # SDIRK3: 3 steps of 3 stages, GMG on every level
    "mms_q2_r7_sdirk3.prm": _edited(
        "mms_q2_r8.prm", drop=("initial refinement",),
        add=[("initial refinement", "7"), ("method", "sdirk3")]),
    # the GD TGV at 16^3, SDIRK2: 1 step of 2 stages
    "tgv16_gd_sdirk2.prm": _edited(
        "tgv16_gd.prm", drop=("time end",),
        add=[("time end", "0.05"), ("method", "sdirk2")]),
    # the lid-driven cavity without its Kelly cycles at refinement 8
    # (257^2 Q1 nodes, 198,147 DoF), steady by pseudo-transient
    # continuation with 'auto' (GMG); the kinetic energy of the solution
    "cavity_ptc.prm": ("examples/cavity_re400.prm", [
        ("text", ("subsection non-linear solver",
                  "subsection post-processing\n  set calculate kinetic "
                  "energy = true\n  set verbosity = verbose\nend\n\n"
                  "subsection non-linear solver")),
        ("text", ("set type                 = kelly",
                  "set type                 = none")),
        ("number mesh adapt", "0"),
        ("initial refinement", "8"),
        ("tolerance", "1e-5"),
        ("subsection non-linear solver", "set solver = pseudo_transient"),
        _VERBOSE_NEWTON,
    ]),
    # phase 6's TGV in two legs: 2 steps with a checkpoint after step 2,
    # then a restart that takes step 3
    "tgv32_restart_a.prm": _edited(
        "tgv32_gmg.prm", drop=("time end",),
        add=[("time end", "0.10"), _restart(True, False, 2)]),
    "tgv32_restart_b.prm": _edited(
        "tgv32_gmg.prm", add=[_restart(False, True, 2)]),
    # phase 9's GD TGV in two legs: a checkpoint after step 1, then step 2
    "tgv16_gd_restart_a.prm": _edited(
        "tgv16_gd.prm", drop=("time end",),
        add=[("time end", "0.05"), _restart(True, False, 1)]),
    "tgv16_gd_restart_b.prm": _edited(
        "tgv16_gd.prm", add=[_restart(False, True, 1)]),
    # phases 4 and 5 with additive Schwarz in place of block-Jacobi
    "taylor_couette_r3_as.prm": _edited(
        "taylor_couette_r3.prm", drop=(_BJ[0],),
        add=[e for e in DECKS["taylor_couette_r3.prm"][1]
             if e[0] == _BJ[0] and e != _BJ] + [_AS]),
    "tgv32_as.prm": _edited("tgv32_3steps.prm", drop=(_BJ[0],),
                            add=[_AS, _VERBOSE_NEWTON]),
})

# phase 12: the decks with Kelly adaptation, on the forest
_GD_KELLY = """# The GD transient Kelly deck of the JAX package's tests
# (tests/test_gd_solver.py::test_gd_kelly_transient_adaptation: an MMS
# solution exp(-t) y^2 on the unit square, Q2-Q1, BDF2, dt 0.05 to 0.2,
# Kelly every 2 steps refining 20 %) at initial refinement 3 (64 cells)
# in place of 2, Newton to 1e-5 in place of 1e-10 (C4: f32 floors near
# 2e-6 here).  Above refinement 3 the velocity-block forest GMG stops
# converging its linear solves on the adapted mesh, in the JAX package
# too (refinement 4: every f64 linear solve after the first adaptation
# at its 1,000-step cap; refinement 6: Newton stalls near 2e-4), and on
# the card refinement 4 took 954 s (ROADMAP C6)
subsection simulation control
  set method        = bdf2
  set time step     = 0.05
  set time end      = 0.2
  set output frequency = 0
end
subsection physical properties
  set kinematic viscosity = 0.1
end
subsection FEM
  set pressure order = 1
end
subsection mesh
  set type = dealii
  set grid type = hyper_cube
  set grid arguments = 0 : 1 : true
  set initial refinement = 3
end
subsection mesh adaptation
  set type                = kelly
  set frequency           = 2
  set fraction refinement = 0.2
end
subsection boundary conditions
  set number = 4
""" + "".join(f"""  subsection bc {i}
    set id = {i}
    set type = function
    subsection u
      set Function expression = exp(-t)*y*y
    end
  end
""" for i in range(4)) + """end
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
  subsection uvwp
    set Function expression = exp(-t)*y*y; 0; x
  end
end
subsection non-linear solver
  set verbosity = verbose
  set tolerance = 1e-5
  set max iterations = 12
end
subsection linear solver
  set relative residual = 1e-4
  set minimum residual = 1e-12
end
"""
# Ghia, Ghia & Shin (1982): the stations of their vertical centerline
# table (Re 400), where phase 12 reads u on the adapted cavity
GHIA_Y = (0.0547, 0.0625, 0.0703, 0.1016, 0.1719, 0.2813, 0.4531, 0.5,
          0.6172, 0.7344, 0.8516, 0.9531, 0.9609, 0.9688, 0.9766)
_CYL_CUTS = [("frequency", "1"), ("checkpoint", "false"), _VERBOSE_NEWTON]
DECKS.update({
    # BASELINE #3 as written (Q1, channel_with_cylinder, refinement 2 =
    # 432 cells on the forest, Kelly on velocity 0.12 / 0.02 at levels
    # 1-5 and at most 30,000 cells, BDF2 dt 0.01, Newton 1e-6, 'auto' ->
    # FGMRES with forest GMG, forces every step), cut: adaptation every
    # step (not every 50th), 7 steps (time end 0.07, not 8.0), no
    # checkpoint.  From step 8 on (2,748 cells) the forest V-cycle needs
    # 1,000-2,800 FGMRES iterations per solve in both packages, at about
    # 32 ms each on an H100 (launch-bound, D0): 15 steps (ending at 9,222
    # cells, as in the JAX package) took 280 s there, GMG evicted after
    # step 11 in f32, and 9 steps 136 s, too much of the script's limit
    "cylinder_kelly.prm": ("examples/cylinder_re100.prm",
                           [("time end", "0.07")] + _CYL_CUTS),
    # the same deck in two legs: 2 steps with a checkpoint written after
    # the second step's adaptation, then a restart that takes steps 3-4
    "cylinder_kelly_a.prm": ("examples/cylinder_re100.prm", [
        ("time end", "0.02"), ("frequency", "1"), _VERBOSE_NEWTON,
        ("text", ("set frequency  = 100", "set frequency  = 2"))]),
    "cylinder_kelly_b.prm": ("examples/cylinder_re100.prm", [
        ("time end", "0.04"), ("frequency", "1"), _VERBOSE_NEWTON,
        ("checkpoint", "false"),
        ("subsection restart", "set restart = true")]),
    # BASELINE #1 (Q1, 64^2 = 4,096 cells on the forest, steady, 3 Kelly
    # cycles refining 20 % and coarsening 5 %, levels up to 10,
    # GMRES(100) with 'auto'), cut: Newton 1e-5 in place of 1e-8, which
    # float32 does not reach (C4), and no field output
    "cavity_kelly.prm": ("examples/cavity_re400.prm", [
        ("tolerance", "1e-5"), _VERBOSE_NEWTON,
        ("subsection simulation control", "set output frequency = 0")]),
    # phase 4's Taylor-Couette r3 deck on the forest (Kelly, no
    # adaptation cycle) with forest GMG (the Q2 -> Q1 p-level, then the
    # forest levels) and GMRES(100)
    "tc_forest_r3.prm": _edited(
        "taylor_couette_r3.prm",
        drop=("subsection linear solver",),
        add=[("text", ("set type = uniform", "set type = kelly")),
             ("subsection linear solver", "set preconditioner = gmg"),
             ("subsection linear solver", "set max iters = 20000")]),
    # the same at refinement 5 (12,288 cells, 149,760 DoF), for C3: in
    # the JAX package in f64, forest GMG converges it where block-Jacobi
    # stalls (2 Newton and 1,893 FGMRES iterations, residuals 4.9123,
    # 9.8383e-4, 9.8237e-9; L2 3.85192531e-06 and 7.16725905e-07); in f32
    # neither package got through it in time (an H100: not done after 15
    # minutes; JAX on the CPU: its solve not ended after 163 CPU
    # minutes).  Not run by the script
    "tc_forest_r5.prm": _edited(
        "taylor_couette_r3.prm",
        drop=("subsection linear solver", "initial refinement"),
        add=[("initial refinement", "5"),
             ("text", ("set type = uniform", "set type = kelly")),
             ("subsection linear solver", "set preconditioner = gmg"),
             ("subsection linear solver", "set max iters = 20000")]),
    # the GD Kelly deck above: velocity-block forest GMG, plain torch
    "gd_kelly.prm": (_GD_KELLY, []),
    # BASELINE #5 at its base mesh (initial refinement 0: 230 cells), cut
    # to one Kelly cycle and Newton 1e-5 (not 3 cycles from refinement 2
    # and 1e-6), no field output: B1 in 3D Q1 on a forest with hanging
    # faces
    "sphere_kelly.prm": ("examples/sphere_re100.prm", [
        ("number mesh adapt", "1"), ("initial refinement", "0"),
        ("tolerance", "1e-5"), ("output frequency", "0"),
        _VERBOSE_NEWTON]),
})


# The JAX package on the CPU in float64 on these decks, written by
#   python3 chip_smoke.py --write-decks DIR && cd DIR &&
#   SOFTX_NO_COMPILE_CACHE=1 JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 \
#     PYTHONPATH=<repo> python -m softx_2020_200_tpu.apps.gls_navier_stokes_2d \
#     taylor_couette_r3.prm
#   (gls_navier_stokes_3d for the tgv32 decks; gls_navier_stokes_2d for
#   mms_q2_r8.prm); the GD decks' values, and every FGMRES count, by
#   scripts/jax_newton_counts.py DECK DIM [gd] in the same directory
JAX_REFERENCE = {
    # 1 solve, 2 Newton and 534 GMRES iterations (residuals 2.4950,
    # 3.2149e-3, 3.1875e-8): scripts/jax_newton_counts.py
    # taylor_couette_r3.prm 2 (at tolerance 1e-10 with GMRES(100): L2
    # 1.16973573e-04 and 2.28645617e-05)
    "taylor_couette_r3.prm": {"l2_velocity": 1.16973147e-04,
                              "l2_pressure": 2.28573939e-05},
    # the same deck with the bf16 Jacobian state through the JAX package's
    # Pallas kernels (B1 rounds the shell's coordinates too, ROADMAP C5):
    # 6 Newton and 3,963 GMRES iterations (residuals 2.4950, 2.1592e-1,
    # 8.7896e-3, 1.3954e-3, 1.3100e-4, 2.0202e-5, 2.3595e-6), L2
    # 1.16971562e-04 and 2.28651001e-05: scripts/jax_newton_counts.py
    # taylor_couette_r3_bf16.prm 2 --pallas-interpret
    "taylor_couette_r3_bf16.prm": {"newton_iterations": 6},
    "tgv32_3steps.prm": {
        "kinetic_energy": [1.225846e-01, 1.225584e-01, 1.225327e-01],
        "enstrophy": [3.686351e-01, 3.688408e-01, 3.692374e-01]},
    "tgv32_gmg.prm": {
        "kinetic_energy": [1.225846e-01, 1.225584e-01, 1.225327e-01],
        "enstrophy": [3.686351e-01, 3.688408e-01, 3.692374e-01],
        # 4 solves, 8 Newton and 32 FGMRES iterations, from
        # scripts/jax_newton_counts.py tgv32_gmg.prm 3
        "fgmres_per_newton": 4.0},
    # 4 solves, 8 Newton and 68 FGMRES iterations (each solve reaches
    # 1e-10 in its second iteration): scripts/jax_newton_counts.py
    # mms_q2_r8.prm 2 (at tolerance 1e-10 the same L2 to 7 digits).
    # Over 4 shards (phase 13; scripts/jax_newton_counts.py mms_q2_r8.prm
    # 2 --shards 4 on 4 virtual CPU devices): f64 the same 8 Newton and
    # 68 FGMRES iterations (2 and 17 per solve) and the same L2 to 9
    # digits; f32 23 Newton and 435 FGMRES, every solve ending above
    # 1e-5 (the XLA kernel's float32 floor on this mesh: absolute element
    # coordinates in J, the time derivative scaled after interpolation;
    # L2 at step 3 5.22e-5), so the f64 run is the witness
    "mms_q2_r8.prm": {
        "l2_velocity": [1.16326913e-04, 7.90071723e-05, 3.32106954e-05],
        "newton_4way": 8, "fgmres_4way": 68},
    # 1 solve, 2 Newton iterations (residual 1.6018 -> 1.4325e-3 ->
    # 7.2114e-6) and 272 FGMRES iterations:
    # scripts/jax_newton_counts.py gd_cavity_r8.prm 2 gd
    "gd_cavity_r8.prm": {
        "forces": {0: (6.19774035e-01, 3.68163531e-01),
                   1: (6.93937321e-01, -4.03186537e-01),
                   2: (-1.59681819e-02, -1.45521351e-02),
                   3: (-1.30945018e+00, 5.00279262e-02)},
        "fgmres_per_newton": 136.0},
    # 3 solves (the BDF2 startup sub-step, then step 2), 6 Newton and 455
    # FGMRES iterations: scripts/jax_newton_counts.py tgv16_gd.prm 3 gd
    "tgv16_gd.prm": {
        "kinetic_energy": [1.249528e-01, 1.249278e-01],
        "enstrophy": [3.749735e-01, 3.752148e-01],
        "fgmres_per_newton": 75.83},
}

# Phase 11, by scripts/jax_newton_counts.py DECK DIM [gd] [--frozen-tau]
# in a directory of --write-decks (JAX CPU f64; Newton and Krylov
# iterations per nonlinear solve, a solve being a BDF step or an SDIRK
# stage)
JAX_REFERENCE.update({
    # 6 solves (3 steps of 2 stages), 12 Newton and 72 FGMRES iterations:
    # scripts/jax_newton_counts.py tgv32_sdirk2.prm 3.  Newton residuals
    # per stage, float64 with --frozen-tau: 1.6385e-1, 1.1528e-4, 4.7272e-8
    # (stage 1 of step 1; the others 3.8e-8 to 1.2e-7 after two
    # iterations).  The same in
    # float32 (no JAX_ENABLE_X64), with and without --frozen-tau, also 2
    # Newton and 12 FGMRES iterations per stage, two iterations ending at
    # 8.68e-7 to 8.89e-7 (exact tau: 8.8480e-7, 8.8879e-7, 8.6685e-7,
    # 8.8333e-7, 8.7575e-7, 8.7209e-7), so float32 has room for two
    "tgv32_sdirk2.prm": {
        "kinetic_energy": [1.225880e-01, 1.225625e-01, 1.225370e-01],
        "enstrophy": [3.686455e-01, 3.688532e-01, 3.692507e-01],
        "newton_per_solve": [2] * 6, "krylov_per_solve": [12] * 6},
    # 9 solves (3 steps of 3 stages), 16 Newton and 121 FGMRES
    # iterations: scripts/jax_newton_counts.py mms_q2_r7_sdirk3.prm 2.
    # The first residual of solve 6 is 1.0024e-5 against the tolerance
    # 1e-5, which float32 cannot tell apart: that solve may take one
    # Newton iteration less ("newton_borderline", 0-based)
    "mms_q2_r7_sdirk3.prm": {
        "l2_velocity": [1.52258766e-05, 1.47758303e-05, 1.42195175e-05],
        "newton_per_solve": [2] * 7 + [1, 1],
        "krylov_per_solve": [15] * 7 + [8, 8], "newton_borderline": [5]},
    # 2 solves (1 step of 2 stages), 4 Newton and 68 FGMRES iterations:
    # scripts/jax_newton_counts.py tgv16_gd_sdirk2.prm 3 gd
    "tgv16_gd_sdirk2.prm": {
        "kinetic_energy": [1.249576e-01], "enstrophy": [3.749884e-01],
        "newton_solves": 2, "newton_iterations": 4,
        "fgmres_per_newton": 17.0},
    # 11 pseudo-steps, 86 FGMRES iterations, steady residual 3.9922e-2 ->
    # 5.1624e-6: scripts/jax_newton_counts.py cavity_ptc.prm 2 (195 s)
    "cavity_ptc.prm": {"ptc_steps": 11, "krylov": 86,
                       "kinetic_energy": 3.790281e-02},
    # additive Schwarz with tau frozen in the Jacobian and the element
    # matrices (--frozen-tau): 1 solve, 2 Newton and 4,885 GMRES
    # iterations (residuals 2.4950, 3.2148e-3, 3.2071e-8):
    # scripts/jax_newton_counts.py taylor_couette_r3_as.prm 2 --frozen-tau.
    # Its GMRES(1000) solves need thousands of steps, and in float32 they
    # need more, in the JAX package as on the card (C4): without
    # JAX_ENABLE_X64 the same command takes 6,372 (3,186 per Newton
    # iteration; residuals 2.4950, 3.2152e-3, 3.7660e-6).  The card's
    # count is held to the float32 one
    "taylor_couette_r3_as.prm": {
        "l2_velocity": 1.16973555e-04, "l2_pressure": 2.37679749e-05,
        "newton_per_solve": [2], "krylov_per_newton": 3186.0,
        "krylov_per_newton_f64": 2442.5},
    # 4 solves, 8 Newton and 255 GMRES iterations (58, 54, 71, 72); KE
    # and enstrophy those of tgv32_3steps.prm to 7 digits:
    # scripts/jax_newton_counts.py tgv32_as.prm 3 --frozen-tau; without
    # JAX_ENABLE_X64 (float32, the count the card is held to): 262
    # (60, 55, 73, 74)
    "tgv32_as.prm": {"newton_per_solve": [2] * 4,
                     "krylov_per_newton": 32.75,
                     "krylov_per_newton_f64": 31.875},
})

# Phase 12, by scripts/jax_newton_counts.py DECK DIM [gd] [--centerline]
# [--l2] in a directory of --write-decks, with JAX_ENABLE_X64=1 (f64) and
# without (f32, the witness for what float32 moves: cells near the
# flagging threshold, Krylov counts)
JAX_REFERENCE.update({
    # 8 solves (the BDF2 startup's two, then one per step), 6
    # adaptations (none in the startup step, as in the JAX package);
    # f64: 25 Newton and 1,046 FGMRES iterations, every solve to 1e-6;
    # f32: 39 Newton and 1,152 FGMRES iterations, the same cells, and
    # the first three solves (the impulsive start, initial residuals
    # 0.12, 18.9 and 5.9) end at 8 Newton iterations above 1e-6 (3.1e-5,
    # 1.7e-5, 1.2e-6: the f32 floor), the others below it (the JAX runs
    # went on to 15 steps; these are their first 7).  Forces on the
    # cylinder (boundary 3) per step, f64
    "cylinder_kelly.prm": {
        "cells_f32": [588, 801, 1089, 1482, 2016, 2748],
        "solves_above_tolerance_f32": 3,
        "forces": [(-1.177192e+00, -1.225015e-03),
                   (-3.490502e-01, 1.978222e-03),
                   (6.614188e-02, 3.738002e-04),
                   (1.484741e-01, -4.102731e-04),
                   (1.251020e-01, -1.560971e-03),
                   (1.011446e-01, -5.982970e-04),
                   (1.181700e-01, -3.980557e-04)],
        # over 4 shards (phase 13; scripts/jax_newton_counts.py
        # cylinder_kelly.prm 2 --shards 4 on 4 virtual CPU devices): the
        # JAX package's sharded loop adapts after the startup step too,
        # so 7 adaptations; f64: 24 Newton and 1,431 FGMRES iterations,
        # every solve to 1e-6; f32: 39 Newton and 2,012 FGMRES, the same
        # cells, the first three solves above 1e-6 (3.1e-5, 1.9e-5,
        # 1.1e-6), as on one device.  Forces on the cylinder per step,
        # f64 and f32 (the f32 run is 3.0e-5 of |Cd| off at step 3)
        "cells_4way_f32": [588, 801, 1089, 1470, 2004, 2724, 3876],
        "solves_above_tolerance_4way_f32": 3,
        "forces_4way": [(-1.177192e+00, -1.225015e-03),
                        (-3.583832e-01, 2.006412e-03),
                        (6.873678e-02, -1.880225e-03),
                        (1.274057e-01, 4.178547e-03),
                        (1.028512e-01, -2.187077e-03),
                        (1.148182e-01, -1.028030e-03),
                        (1.062586e-01, -8.115685e-04)],
        "forces_4way_f32": [(-1.177200e+00, -1.230165e-03),
                            (-3.583775e-01, 2.009785e-03),
                            (6.873783e-02, -1.878135e-03),
                            (1.274057e-01, 4.179971e-03),
                            (1.028507e-01, -2.185809e-03),
                            (1.148183e-01, -1.026993e-03),
                            (1.062585e-01, -8.110022e-04)]},
    # 4 solves; f64: Newton 5, 2, 2, 2 and FGMRES 60, 20, 19, 18; f32:
    # Newton the same, FGMRES 60, 21, 19, 19, the same cells
    "cavity_kelly.prm": {
        "cells_f32": [6430, 10120, 15934],
        "newton_per_solve": [5, 2, 2, 2], "krylov_per_solve": [60, 21, 19, 19],
        "centerline_u": [-7.92779847e-02, -8.99959540e-02, -1.00391456e-01,
                         -1.42054021e-01, -2.37074742e-01, -3.22131319e-01,
                         -1.69876594e-01, -1.13555366e-01, 2.07851453e-02,
                         1.60001160e-01, 2.87062415e-01, 5.58310956e-01,
                         6.17060968e-01, 6.84801296e-01, 7.58751989e-01]},
    # f64: 2 Newton and 116 FGMRES iterations (residuals 2.4950,
    # 3.2151e-3, 3.2135e-8); f32: 2 and 134 (4.0971e-6 last), L2
    # 1.16970179e-04 and 2.28668396e-05
    "tc_forest_r3.prm": {"newton": 2, "fgmres_per_newton": 58.0,
                         "fgmres_per_newton_f32": 67.0,
                         "l2_velocity": 1.16973958e-04,
                         "l2_pressure": 2.28652564e-05},
    # 5 solves, 2 adaptations (64 -> 103 -> 166 cells in f64 and f32);
    # f64: 10 Newton and 704 FGMRES iterations (152, 146, 172, 117, 117);
    # f32: 10 Newton and 1,622 (the first solve 1,070)
    "gd_kelly.prm": {"cells_f32": [103, 166], "newton": 10,
                     "krylov_f32": 1622, "krylov_f64": 704,
                     "l2_f32": (1.52433668e-05, 7.33142733e-05),
                     "l2_f64": (1.52243905e-05, 7.33978135e-05)},
    # 2 solves, 1 adaptation (230 -> 468 cells; the base mesh has no
    # coarser forest level, so the first solve takes block-Jacobi); with
    # tau frozen in the Jacobian (--frozen-tau, the card's linearization):
    # f32 Newton 6 and 9, Krylov 428 and 74 (f64 6 and 9, 409 and 74);
    # with the exact tau f64 takes 3 and 5 Newton iterations.  The force
    # on the sphere after the last solve, f64 (exact tau)
    "sphere_kelly.prm": {"cells_f32": [468], "newton_per_solve": [6, 9],
                         "krylov_per_solve": [428, 74],
                         "force_sphere": (2.579897e-01, -5.296403e-08,
                                          -2.151057e-16)},
})

# Phase 15, by scripts/jax_newton_counts.py sphere_r2.prm 3 --frozen-tau
# in a directory of --write-decks (f32, without JAX_ENABLE_X64; the
# card's linearization) and by the same command without --frozen-tau
# with JAX_ENABLE_X64=1 at the deck's own tolerance 1e-6 (the forces)
JAX_REFERENCE.update({
    # 4 solves, 3 adaptations (14,720 -> 30,176 -> 61,858 -> 126,811
    # cells in f32 and f64), forest GMG on 3, 4, 5 and 6 levels, no
    # eviction; f32: 17 Newton and 348 FGMRES iterations, each solve
    # under 1e-5 (3.0e-6, 2.3e-6, 5.4e-6, 1.4e-6).  At the deck's 1e-6
    # f32 stalls every solve at 1.20e-6 to 1.34e-6 (12, 9, 8, 7 Newton
    # and 226, 147, 123, 110 FGMRES iterations), f64 reaches it (9, 3,
    # 3, 2 Newton and 188, 67, 58, 43 FGMRES).  The force on the sphere
    # after each cycle, f64
    "sphere_r2.prm": {
        "cells_f32": [30176, 61858, 126811],
        "newton_per_solve": [9, 4, 2, 2],
        "krylov_per_solve": [182, 82, 40, 44],
        "forces": [(4.014357e-01, 1.322727e-16, -1.374768e-16),
                   (3.922065e-01, -2.009144e-08, 4.901524e-13),
                   (4.095647e-01, -7.684080e-07, 6.631605e-13),
                   (4.260988e-01, 5.410308e-07, -9.901189e-08)]},
})

# Tolerances of the card's float32 runs against the float64 reference.
# L2 errors at refinement 3, relative: float32 runs of this deck came
# within 0.15% of the reference (the port on an H100: 0.036% velocity,
# 0.048% pressure; on the CPU: 0.148% and 0.082%), and the same deck
# with one stabilization term dropped (gls viscous adjoint = false, f64)
# moves them by 17.6% and 1.72%.  0.5% passes the first and fails the
# second.  The MMS deck is held to the same bound.
L2_RTOL = 5e-3
# KE and enstrophy per step: integrals of an O(1) field after Newton to
# 1e-6 in both runs; f32 rounding of the state moves them by about 1e-7
# relative, and the reference prints 7 digits.
ENERGY_RTOL = 1e-5
# GD cavity forces per boundary: the largest component error over the
# boundary's largest reference component.  Float32 runs of the deck came
# within 4.7e-5 (the port on an H100) and 2.2e-5 (on the CPU) of the f64
# reference.  The f64 run stopped one Newton iteration early (tolerance
# 1e-2) is off by 3.8e-2 to 0.91 on the four boundaries, and one taken a
# Newton iteration further (tolerance 1e-9, residual 7.2e-6 -> 1.3e-10)
# by 2.5e-4, 2.1e-4 and 1.1e-2 on boundaries 0-2 (1.6e-4 on 3).  2e-4
# passes the first two and fails both controls.
FORCE_RTOL = 2e-4
# FGMRES iterations per Newton iteration on the GD cavity against the
# JAX package's: room for f32 and summation order (8 % between two
# calls of one deck was seen on the GLS decks); a broken cycle needs far
# more, since block-Jacobi does not converge this deck at all
FGMRES_RTOL = 0.25
# Phase 12.  Cells after each adaptation against the JAX package's f32
# run: float32 moves a cell across the flagging threshold now and then
# (the GD deck's first adaptation: 406 cells in f32, 403 in f64), and one
# cell flagged the other way is 3 more or fewer
CELLS_RTOL = 0.02
# Forces on the cylinder per step (and on the sphere) against the f64
# run, over the step's largest reference component
FORCE_KELLY_RTOL = 1e-2
# The cavity's centerline u at Ghia's stations, absolute (u is O(1))
CENTERLINE_ATOL = 2e-3
# The GD Kelly deck's final L2 errors against the JAX f32 run's
GD_L2_RTOL = 2e-2


def deck_text(name: str) -> str:
    """The deck ``name`` of DECKS: its example with the edits applied.
    An edit ``(key, value)`` replaces ``set key = ...``; an edit
    ``("subsection S", line)`` adds ``line`` at the top of subsection S;
    ``("text", (old, new))`` replaces the text ``old``."""
    src, edits = DECKS[name]
    if "\n" in src:             # the deck's text itself
        text = src
    else:
        with open(os.path.join(ROOT, src)) as fh:
            text = fh.read()
    for key, value in edits:
        if key == "text":
            n = text.count(value[0])
            text = text.replace(*value)
        elif key.startswith("subsection "):
            pat = re.compile(rf"^([ \t]*){re.escape(key)}[ \t]*$", re.M)
            text, n = pat.subn(lambda m: f"{m.group(0)}\n{m.group(1)}  "
                               f"{value}", text, count=1)
        else:
            pat = re.compile(rf"^([ \t]*set[ \t]+{re.escape(key)}[ \t]*=).*$", re.M)
            text, n = pat.subn(lambda m: f"{m.group(1)} {value}", text,
                               count=1)
        if n != 1:
            raise ValueError(f"{src}: cannot apply edit {key!r}")
    return text


def write_decks(directory: str) -> None:
    os.makedirs(directory, exist_ok=True)
    for name in DECKS:
        with open(os.path.join(directory, name), "w") as fh:
            fh.write(deck_text(name))


class Failed(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failed(what)


def run(cmd) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unavailable ({exc})"
    return (out.stdout or out.stderr).strip()


# ----------------------------------------------------------------------
# phase 1
# ----------------------------------------------------------------------
def phase_environment(torch) -> str:
    print("== phase 1: environment")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    from softx_2020_200_tpu_torch.ops.cuda_build import find_nvcc
    nvcc = run([find_nvcc(), "--version"]).splitlines()
    print(f"nvcc: {nvcc[-1] if nvcc else 'unavailable'}")
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton: not installed")
    return smi.splitlines()[0] if smi else smi


# ----------------------------------------------------------------------
# phase 2
# ----------------------------------------------------------------------
PARENT_PACKAGE = "parent_softx_2020_200_tpu_torch"


def load_parent(root: str):
    """B1's, B2's and B3's wrappers (``ops/gls_kernel.py``,
    ``ops/lattice_kernel.py``, ``ops/lattice_gd_kernel.py``) of the
    ``softx_2020_200_tpu_torch`` in
    another checkout ``root`` (a ``git archive`` of the parent commit),
    imported beside this one under another package name; they build
    their kernels from that checkout's sources into its own ``build/``."""
    import importlib
    import importlib.util
    pkg = os.path.join(os.path.abspath(root), "softx_2020_200_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        PARENT_PACKAGE, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[PARENT_PACKAGE] = module
    spec.loader.exec_module(module)
    ops = f"{PARENT_PACKAGE}.ops"
    return types.SimpleNamespace(
        root=os.path.abspath(root),
        cuda_build=importlib.import_module(f"{ops}.cuda_build"),
        gls_kernel=importlib.import_module(f"{ops}.gls_kernel"),
        lattice_kernel=importlib.import_module(f"{ops}.lattice_kernel"),
        lattice_gd_kernel=importlib.import_module(
            f"{ops}.lattice_gd_kernel"))


def phase_build(parent=None) -> None:
    print("== phase 2: build (one nvcc per source, in parallel)")
    from softx_2020_200_tpu_torch.ops import (cuda_build, gls_kernel,
                                              lattice_gd_kernel,
                                              lattice_kernel)
    t0 = time.perf_counter()
    sources = [gls_kernel.SOURCE, lattice_kernel.SOURCE,
               lattice_gd_kernel.SOURCE]
    parent_builds, failed = {}, []
    if parent is not None:
        # the parent's B1, B2 and B3, compiled by its own cuda_build into
        # its own build/, while this checkout's compile
        def build_parent():
            try:
                parent_builds.update(parent.cuda_build.compile_sources(
                    [parent.gls_kernel.SOURCE, parent.lattice_kernel.SOURCE,
                     parent.lattice_gd_kernel.SOURCE]))
            except RuntimeError as exc:
                failed.append(exc)
        thread = threading.Thread(target=build_parent)
        thread.start()
    builds = cuda_build.compile_sources(sources)
    if parent is not None:
        thread.join()
        check(not failed, f"parent build: {failed}")
        for source, build in parent_builds.items():
            print(f" parent {os.path.relpath(source, parent.root)} -> "
                  f"{os.path.relpath(build.path, parent.root)} "
                  f"({build.seconds:.2f} s)")
        parent.gls_kernel.get_build()
        parent.lattice_kernel.get_build()
        parent.lattice_gd_kernel.get_build()
    print(f"all {len(sources) + len(parent_builds)} built in "
          f"{time.perf_counter() - t0:.2f} s")
    modes = {"0": "primal", "1": "tangent", "2": "probe"}
    spills = []
    for source, build in builds.items():
        name = os.path.splitext(os.path.basename(source))[0]
        current = source in sources
        print(f" {os.path.relpath(source, ROOT)} -> "
              f"{os.path.relpath(build.path, ROOT)} ({build.seconds:.2f} s)")
        # ptxas reports each template instance <dim, [degree, points per
        # axis,] mode[, split][, state bytes], operand bytes[, points per
        # axis]> by its mangled name, then its spills and registers
        entry = None
        for line in build.log.splitlines():
            inst = re.search(rf"({name}(?:_reg)?_kernel)I((?:Li\d+E)+)E",
                             line)
            if inst and "Compiling entry" in line:
                args = re.findall(r"Li(\d+)E", inst.group(2))
                # B1's STAGED instances end in their points per axis; every
                # instance then in its operands' bytes (4: f32, 2: bf16),
                # B1's and B2's before it in their state's bytes, and B1's
                # register route, before that, in its threads per element
                points = (args.pop() if inst.group(1) == "gls_element_kernel"
                          else None)
                state = " bf16op" if args.pop() == "2" else ""
                if name != "gd_lattice" and args.pop() == "2" and not state:
                    state = " bf16"
                split = (f" split={args.pop()}"
                         if inst.group(1) == "gls_element_reg_kernel" else "")
                *shape, mode = args
                shape += [points] if points else []
                dims = " ".join(f"{a}={v}" for a, v in zip("dkq", shape))
                entry = (f"{inst.group(1)} {dims} {modes[mode]}{split}"
                         f"{state}")
                print(f"  ptxas {entry}:")
            elif "registers" in line or "spill" in line or "error" in line:
                print(f"    {line.replace('ptxas info    :', '').strip()}")
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if current and m and (int(m.group(1)) or int(m.group(2))):
                    spills.append(f"{entry}: {line.strip()}")
    check(not spills, "ptxas spills: " + "; ".join(spills))
    print("  no spill in any B1, B2 or B3 variant")
    gls_kernel.get_build()
    lattice_kernel.get_build()
    lattice_gd_kernel.get_build()
    # each variant's shared memory against the Python mirror (the CPU
    # tests hold that to the card's 227 KB), and its blocks per SM; the
    # tangent and the probe with float32 and with bf16 state, every mode
    # with bf16 operands (state and operand bytes: 4, 4; 2, 4; 2, 2)
    for name, mod in (("B1", gls_kernel), ("B2", lattice_kernel)):
        for shape in sorted(mod.SUPPORTED):
            variants = [(0, 1)]
            if shape in mod.REGISTER_SHAPES:
                variants += [(1, n) for n in (gls_kernel.REG_SPLITS[shape[0]]
                                              if mod is gls_kernel else (1,))]
            for (route, n), mode, (sb, ob) in (
                    (v, m, b) for v in variants for m in range(3)
                    for b in (((4, 4), (2, 4), (2, 2))
                              if m in mod.BF16_MODES else ((4, 4), (2, 2)))):
                extra = (n,) if mod is gls_kernel else ()
                blocks, smem, threads = mod.config_on_card(
                    *shape, mode, route, *extra, state_bytes=sb,
                    operand_bytes=ob)
                cfg = mod.tile_config(*shape, mode, route, *extra,
                                      state_bytes=sb, operand_bytes=ob)
                tag = mod.MODES[mode] + (" bf16op" if ob == 2 else
                                         " bf16" if sb == 2 else "")
                print(f"  {name} {shape} {('staged', 'registers')[route]:9s} "
                      f"/{n} {tag:12s}: {threads} threads, {smem} "
                      f"B shared memory, {blocks} blocks per SM")
                check(smem == cfg["smem_bytes"] and threads == cfg["threads"]
                      and blocks >= 1,
                      f"{name} {shape} {tag} {route}: {smem} B, {threads} "
                      f"threads (mirror {cfg}), {blocks} blocks per SM")
    for shape in sorted(gls_kernel.OTHER_POINTS):
        for mode in range(3):
            for sb, ob in (((4, 4), (2, 4), (2, 2))
                           if mode in gls_kernel.BF16_MODES
                           else ((4, 4), (2, 2))):
                blocks, smem, threads = gls_kernel.config_on_card(
                    *shape[:2], mode, 0, state_bytes=sb, points=shape[2],
                    operand_bytes=ob)
                cfg = gls_kernel.tile_config(*shape[:2], mode, 0,
                                             state_bytes=sb, points=shape[2],
                                             operand_bytes=ob)
                tag = gls_kernel.MODES[mode] + (" bf16op" if ob == 2 else
                                                " bf16" if sb == 2 else "")
                print(f"  B1 {shape} staged    /1 {tag:12s}: {threads} "
                      f"threads, {smem} B shared memory, {blocks} blocks per "
                      "SM")
                check(smem == cfg["smem_bytes"] and threads == cfg["threads"]
                      and blocks >= 1,
                      f"B1 {shape} {tag}: {smem} B, {threads} threads "
                      f"(mirror {cfg}), {blocks} blocks per SM")
    gk = lattice_gd_kernel
    for dim in (2, 3):
        for route in (0, 1) if dim in gk.REGISTER_DIMS else (0,):
            for mode, ob in ((m, b) for m in range(2) for b in (4, 2)):
                blocks, smem, threads = gk.config_on_card(
                    dim, mode, route, operand_bytes=ob)
                cfg = gk.tile_config(dim, mode, route, operand_bytes=ob)
                tag = gk.MODES[mode] + (" bf16op" if ob == 2 else "")
                print(f"  B3 d={dim} {gk.ROUTE_NAMES[route]:9s} "
                      f"{tag:14s}: {threads} threads, {smem} B "
                      f"shared memory, {blocks} blocks per SM")
                check(smem == cfg["smem_bytes"] and threads == cfg["threads"]
                      and blocks >= 1,
                      f"B3 d={dim} {tag} {route}: {smem} B, {threads} "
                      f"threads (mirror {cfg}), {blocks} blocks per SM")


# ----------------------------------------------------------------------
# phase 3: B1
# ----------------------------------------------------------------------
def _space(dim: int, degree: int, cells, seed: int):
    """A non-affine FE space: a curved shell (refinement ``cells``) in 2D,
    a box of ``cells`` per axis (an int, or one per axis) with randomly
    moved interior vertices in 3D, and in 2D when ``cells`` is a tuple."""
    import numpy as np
    from softx_2020_200_tpu_torch.fem import mesh as M
    from softx_2020_200_tpu_torch.fem.dof import FESpace
    if dim == 2 and isinstance(cells, int):
        m = M.generate_mesh("hyper_shell", "0, 0 : 0.25 : 1 : 12 : true",
                            dim=2, initial_refinement=cells)
    else:
        n = np.broadcast_to(np.asarray(cells), (dim,))
        m = M.subdivided_hyper_rectangle([0.0] * dim, [1.0] * dim,
                                         [int(c) for c in n], True, dim=dim)
        v = m.vertices
        inner = np.all((v > 1e-9) & (v < 1 - 1e-9), axis=1)
        rng = np.random.default_rng(seed)
        v[inner] += rng.uniform(-0.2, 0.2, (int(inner.sum()), dim)) / n
        m.structured_shape = None      # no longer a lattice of translates
    return FESpace(m, degree)


def _inputs(torch, op, seed: int):
    g = torch.Generator().manual_seed(seed)
    N, c, d = op.n_nodes, op.nc, op.dim
    E = op.space.n_elements

    def rnd(*shape, s=1.0):
        return (s * torch.randn(*shape, generator=g, dtype=torch.float64)
                ).to(op.device, op.dtype)

    return dict(u=rnd(N, c, s=0.3), v=rnd(N, c), prev=rnd(N, d, s=0.2),
                fq=rnd(E, op.n_q, d))


def _rel(torch, a, b) -> tuple[float, float]:
    """(max-abs error, over the max-abs scale of ``b``), in float32 (bf16
    outputs are widened first)."""
    a, b = a.float(), b.float()
    err = float((a - b).abs().max())
    return err, err / float(b.abs().max())


def _median_ms(torch, fn, reps: int = 20) -> float:
    """Median time of one call of ``fn`` over ``reps`` calls: CUDA events
    around each call, after one warm-up.  A call that launches little
    work measures the host's launch cost as much as the device's."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def parent_calls(torch, parent, op, ue, due, args) -> dict:
    """The parent's wrapper of the operator's kernel (B1 or B2, from
    ``load_parent``), built from the same basis tables, and its primal,
    tangent and node blocks through its own public methods on the same
    inputs: called as the solvers call it."""
    k = op.kernel
    q1d = round(k.nq ** (1 / k.dim))
    _, w, B, G, H = op.space.basis.quadrature(q1d)
    common = dict(dim=k.dim, degree=k.degree, B=B, G=G, H=H, w=w, nu=k.nu,
                  stab=k.stab, dtype=torch.float32, device=ue.device)
    if op.layout is None:
        pk = parent.gls_kernel.GLSElementKernel(**common)
    else:
        pk = parent.lattice_kernel.LatticeGLSKernel(
            xe0=op.layout.elem_coords_grid_order()[0], **common)
    return {"primal": lambda: pk.residual(ue, *args),
            "tangent": lambda: pk.tangent(ue, due, *args),
            "node blocks": lambda: pk.node_blocks(ue, *args)}


def _variants(torch, space, device, seed: int, lsic: bool = False,
              n_q1d: int | None = None, parent=None):
    """(operator, kernel calls, plain calls, forced, parent's calls,
    state) on one space with seeded float32 inputs: the primal residual,
    the tangent and the node blocks.  The plain tangent and node blocks
    differentiate with tau (and the LSIC coefficient) frozen, as the
    kernels do.  ``forced(route, split)`` gives the kernel's calls on a
    forced route; the parent's calls are None without ``parent``; state
    is (operator, ue, due, args), for ``_bf16_variants``.  The operator
    picks B2 on a lattice of translates and B1 otherwise."""
    from softx_2020_200_tpu_torch.ops import batched_kernel as bk
    from softx_2020_200_tpu_torch.ops import lattice_kernel as lk
    from softx_2020_200_tpu_torch.solvers.gls import GLSOperator, StabFlags
    frozen_flags = StabFlags(lsic=lsic, frozen_tau=True)
    op = GLSOperator(space, nu=0.01, n_q1d=n_q1d, stab=frozen_flags,
                     dtype=torch.float32, device=device)
    x = _inputs(torch, op, seed=seed)
    k = op.kernel
    full, frozen = k.plain(StabFlags(lsic=lsic)), k.plain(frozen_flags)
    if op.layout is None:
        ue, due = op._soa(x["u"]), op._soa(x["v"])
        args = (op.xe_soa, op._soa(x["prev"]), op._fq_soa(x["fq"]), op.h,
                1.5, 20.0)
        plain = {"primal": lambda: full(ue, *args),
                 "tangent": lambda: bk.tangent_batched(frozen, ue, due,
                                                       *args),
                 "node blocks": lambda: bk.node_blocks_batched(frozen, ue,
                                                               *args)}
    else:
        ue, due = op._rows(x["u"]), op._rows(x["v"])
        args = (op._rows(x["prev"]), op._fq_rows(x["fq"]), 1.5, 20.0)
        plain = {"primal": lambda: full(ue, *args),
                 "tangent": lambda: lk.lattice_tangent(frozen, ue, due,
                                                       *args),
                 "node blocks": lambda: lk.lattice_node_blocks(
                     frozen, ue, *args, op.nn)}
    kernel = {"primal": lambda: k.residual(ue, *args),
              "tangent": lambda: k.tangent(ue, due, *args),
              "node blocks": lambda: k.node_blocks(ue, *args)}

    def forced(route, split=None):
        kw = {} if split is None else {"split": split}
        return {what: (lambda m=m, d=d: k._call(m, ue, d, args, route, **kw))
                for what, m, d in (("primal", 0, None), ("tangent", 1, due),
                                   ("node blocks", 2, None))}

    parent_fns = (None if parent is None
                else parent_calls(torch, parent, op, ue, due, args))
    return op, kernel, plain, forced, parent_fns, (op, ue, due, args)


def _skewed_rows(torch, x):
    """bf16 rows of ``x`` [..., E] at an even row pitch that is not a
    multiple of 8 elements (16 bytes), so a launch on them takes the
    4-byte cp.async path; a single row starts 4 bytes past a 16-byte
    boundary instead."""
    E = x.shape[-1]
    if x.dim() == 1:
        return torch.zeros(E + 2, dtype=torch.bfloat16,
                           device=x.device)[2:].copy_(x.float())
    pitch = (E + 1) // 2 * 2 + 2
    pitch += 2 if pitch % 8 == 0 else 0
    out = torch.zeros(*x.shape[:-1], pitch, dtype=torch.bfloat16,
                      device=x.device)
    out[..., :E] = x.float()
    return out[..., :E]


def _bf16_variants(torch, state, skewed: bool = False):
    """(kernel calls, plain calls, forced) of the bf16-state tangent
    ("tangent bf16") and node blocks ("node blocks bf16") on the float32
    state of ``_variants``, rounded to bf16 once: in the operator's rows
    (``state_rows``: a row pitch of 8k elements, TMA wherever the other
    rows allow it) or, ``skewed``, at a pitch that takes the 4-byte
    cp.async path.  The plain version reads the same rounded state,
    widened to float32, with tau frozen."""
    from softx_2020_200_tpu_torch.ops import batched_kernel as bk
    from softx_2020_200_tpu_torch.ops import lattice_kernel as lk
    from softx_2020_200_tpu_torch.ops.persistent_tiles import state_rows
    from softx_2020_200_tpu_torch.solvers.gls import StabFlags
    op, ue, due, args = state
    k = op.kernel
    rows = (lambda x: _skewed_rows(torch, x)) if skewed else state_rows
    frozen = k.plain(StabFlags(lsic=op.stab.lsic, frozen_tau=True))
    n_state = 5 if op.layout is None else 3     # ue, xe, up, fq, h / ue, up, fq
    s16 = [rows(t) for t in (ue, *args[:n_state - 1])]
    args16 = (*s16[1:], *args[n_state - 1:])
    wide = [t.float() for t in s16]
    wargs = (*wide[1:], *args[n_state - 1:])
    ue16, uw = s16[0], wide[0]
    if op.layout is None:
        plain = {"tangent bf16": lambda: bk.tangent_batched(
                     frozen, uw, due, *wargs),
                 "node blocks bf16": lambda: bk.node_blocks_batched(
                     frozen, uw, *wargs)}
    else:
        plain = {"tangent bf16": lambda: lk.lattice_tangent(
                     frozen, uw, due, *wargs),
                 "node blocks bf16": lambda: lk.lattice_node_blocks(
                     frozen, uw, *wargs, op.nn)}
    kernel = {"tangent bf16": lambda: k.tangent(ue16, due, *args16),
              "node blocks bf16": lambda: k.node_blocks(ue16, *args16)}

    def forced(route, split=None):
        kw = {} if split is None else {"split": split}
        return {"tangent bf16": lambda: k._call(1, ue16, due, args16, route,
                                                **kw),
                "node blocks bf16": lambda: k._call(2, ue16, None, args16,
                                                    route, **kw)}

    return kernel, plain, forced


def _check_bf16(torch, label, E, state, has_registers, dim=None) -> float:
    """The bf16-state tangent and node blocks against their plain version
    on the same rounded state, on every route, in both row layouts (TMA
    where the rows allow it, and 4-byte cp.async)."""
    worst = 0.0
    for skewed in (False, True):
        kernel, plain, forced = _bf16_variants(torch, state, skewed)
        worst = max(worst, _check_settings(
            torch, f"{label} bf16{' skewed' if skewed else ''}", E, kernel,
            forced, _outputs(torch, plain), has_registers, dim))
    return worst


def _outputs(torch, calls) -> dict:
    out = {what: fn() for what, fn in calls.items()}
    torch.cuda.synchronize()
    return out


def _check_outputs(torch, label: str, E: int, kernel, want,
                   rtol: float = KERNEL_RTOL, rels=None) -> float:
    """Each kernel output against the plain one (``want``, computed
    once); the worst max-abs error (each relative error is appended to
    ``rels`` when given).  Raises if one is off by more than ``rtol`` of
    scale, or is not of the plain one's dtype."""
    worst = 0.0
    for what in kernel:
        got = kernel[what]()
        torch.cuda.synchronize()
        err, rel = _rel(torch, got, want[what])
        worst = max(worst, err)
        if rels is not None:
            rels.append(rel)
        print(f"  {label:44s} E={E:7d} {what:11s} max_abs_err {err:.3e}  "
              f"rel {rel:.3e}")
        check(rel < rtol and bool(torch.isfinite(got.float()).all())
              and got.dtype == want[what].dtype,
              f"kernel {what} {label} E={E}: rel error {rel:.3e} "
              f"({got.dtype})")
    return worst


def _compare(torch, label: str, E: int, kernel, plain,
             rtol: float = KERNEL_RTOL) -> float:
    return _check_outputs(torch, label, E, kernel, _outputs(torch, plain),
                          rtol)


def _settings(has_registers: bool, dim: int | None = None) -> list:
    """(name, route, split) of every forced route the kernel can take
    besides its default: STAGED, and REGISTERS where the shape has it
    (for B1, ``dim`` given: with each of its threads per element)."""
    from softx_2020_200_tpu_torch.ops import gls_kernel as gk
    out = [("staged", "staged", None)]
    if has_registers:
        out += ([(f"registers/{n}", "registers", n)
                 for n in gk.REG_SPLITS[dim]] if dim else
                [("registers", "registers", None)])
    return out


def _check_settings(torch, label, E, kernel, forced, want, has_registers,
                    dim=None, rtol: float = KERNEL_RTOL, rels=None) -> float:
    """The default calls and every forced route against ``want``."""
    worst = _check_outputs(torch, f"{label} [default]", E, kernel, want,
                           rtol, rels)
    for name, route, split in _settings(has_registers, dim):
        worst = max(worst, _check_outputs(torch, f"{label} [{name}]", E,
                                          forced(route, split), want, rtol,
                                          rels))
    return worst


# B1 parity meshes (dim, degree, refinement or cells per axis): 192, 192,
# 216 and 216 elements, so each launch spans several tiles (32 elements;
# 16 at 3D Q2) and 3D ends in a ragged one with E % 4 == 0 (a partial
# TMA box); then moved boxes with E % 4 != 0 (195 and 210 elements,
# 4-byte loads) and below one tile (9 and 12 elements).  Each runs
# without and with LSIC.
PARITY_SHAPES = ((2, 1, 2), (2, 2, 2), (3, 1, 6), (3, 2, 6),
                 (2, 1, (15, 13)), (2, 2, (15, 13)), (3, 1, (7, 6, 5)),
                 (3, 2, (7, 6, 5)), (2, 1, (3, 3)), (2, 2, (3, 3)),
                 (3, 1, (2, 2, 3)), (3, 2, (2, 2, 3)))


def phase_kernel_parity(torch, device) -> float:
    from softx_2020_200_tpu_torch.ops import gls_kernel as gk
    print("== phase 3: B1 parity (CUDA kernel vs plain PyTorch, float32, "
          f"tolerance {KERNEL_RTOL:g} of the max-abs scale; every route, "
          "both load paths; float32 and bf16 state)")
    worst = 0.0
    for dim, degree, cells in PARITY_SHAPES:
        space = _space(dim, degree, cells, seed=dim * 10 + degree)
        for lsic in (False, True):
            op, kernel, plain, forced, _, state = _variants(
                torch, space, device, seed=dim * 10 + degree, lsic=lsic)
            check(op.layout is None, "B1 parity mesh took the lattice path")
            label = f"d={dim} k={degree}{' lsic' if lsic else ''}"
            reg = (dim, degree) in gk.REGISTER_SHAPES
            worst = max(worst, _check_settings(
                torch, label, space.n_elements, kernel, forced,
                _outputs(torch, plain), reg, dim))
            worst = max(worst, _check_bf16(torch, label, space.n_elements,
                                           state, reg, dim))
    # Q1 with 3 points per axis (STAGED only; the forest multigrid's
    # levels below a Q2 mesh's Q1 p-level) on the Q1 parity meshes
    for (dim, degree, q1d), cells in (
            (shape, c) for shape in sorted(gk.OTHER_POINTS)
            for d, k, c in PARITY_SHAPES if (d, k) == shape[:2]):
        space = _space(dim, degree, cells, seed=dim * 10 + q1d)
        for lsic in (False, True):
            op, kernel, plain, forced, _, state = _variants(
                torch, space, device, seed=dim * 10 + q1d, lsic=lsic,
                n_q1d=q1d)
            check(op.layout is None and op.kernel.q1d == q1d,
                  "B1 three-point parity mesh took another path")
            label = f"d={dim} k={degree} q={q1d}{' lsic' if lsic else ''}"
            worst = max(worst, _check_settings(
                torch, label, space.n_elements, kernel, forced,
                _outputs(torch, plain), False, dim))
            worst = max(worst, _check_bf16(torch, label, space.n_elements,
                                           state, False, dim))
    return worst


def _graph_ms(torch, fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph, whose replay is timed with CUDA events (median of 5), so
    the host's launch cost is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                       # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = _median_ms(torch, graph.replay, reps=5) / reps
    del graph
    return ms


def _time_variants(torch, label, E, kernel, plain, times, parent_fns=None,
                   settings=(), forced=None, time_plain=True):
    """Times of each variant at one shape: the kernel's device time (a
    CUDA graph of 20 calls, ``ms``) and one event-timed call of it, which
    adds the host's launch cost (``call_ms``); with ``parent_fns`` (the
    parent's kernel through its own wrapper on the same inputs) the same
    for it (``ms_parent``, ``call_ms_parent``), timed in turns with the
    kernel (parent, kernel, kernel, parent); each forced route of
    ``settings`` (``_settings``) through ``forced``; and the plain
    version's event-timed call (median of 5, of 2 for the plain node
    blocks, whose nn*c forward-mode passes take up to seconds; None
    without ``time_plain``, or for the variants not named in it).  A
    shape's row gathers the variants of several calls (float32, bf16
    state, bf16 operands)."""
    row = times.setdefault(label, {"E": E})
    for what in kernel:
        r = row[what] = {}
        if parent_fns is not None:
            p1 = _graph_ms(torch, parent_fns[what])
            k1 = _graph_ms(torch, kernel[what])
            k2 = _graph_ms(torch, kernel[what])
            p2 = _graph_ms(torch, parent_fns[what])
            r["ms"], r["ms_parent"] = (k1 + k2) / 2, (p1 + p2) / 2
            r["call_ms_parent"] = _median_ms(torch, parent_fns[what])
        else:
            r["ms"] = _graph_ms(torch, kernel[what])
        r["call_ms"] = _median_ms(torch, kernel[what])
        r["settings"] = {}
        for name, route, split in settings:
            fn = forced(route, split)[what]
            r["settings"][name] = (_graph_ms(torch, fn),
                                   _median_ms(torch, fn))
        timed = time_plain is True or (time_plain and what in time_plain)
        r["plain_ms"] = (_median_ms(torch, plain[what],
                                    reps=2 if "node blocks" in what else 5)
                         if timed else None)
        alt = "".join(f"; {n} {t:.4f} (call {c:.4f})"
                      for n, (t, c) in r["settings"].items())
        prev = (f"; parent {r['ms_parent']:.4f} (call "
                f"{r['call_ms_parent']:.4f})" if "ms_parent" in r else "")
        pl = (f"; plain {r['plain_ms']:.4f} ms" if timed else
              "; plain not timed")
        print(f"  {label:32s} E={E:7d} {what:16s} kernel [default] "
              f"{r['ms']:.4f} ms (call {r['call_ms']:.4f}){prev}{alt}{pl}")
        torch.cuda.empty_cache()


# B1's main-path shapes: (label, dim, degree, refinement or cells/axis)
B1_SHAPES = (("2D Q2 Taylor-Couette r3", 2, 2, 3),
             ("2D Q2 Taylor-Couette r5", 2, 2, 5),
             ("3D Q1 32^3 (moved)", 3, 1, 32),
             ("3D Q1 64^3 (moved)", 3, 1, 64))


def _host_spaces(only: set):
    """Start building, in one thread, the FE spaces that phases 3b (B1's
    shapes) and 3c (B2's periodic lattices) time, as far as ``only``
    runs them (host NumPy work: the 96^3 lattice alone takes about half
    a minute), so that it overlaps phase 2's compilers; returns a
    function from a shape's label to its space, which waits for it."""
    import concurrent.futures
    from softx_2020_200_tpu_torch import native
    from softx_2020_200_tpu_torch.fem import basis, dof, mesh  # noqa: F401
    # the modules and the native mesh library (built at first use) are
    # loaded here, so that the thread never races the main one for them
    native.get_lib()
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    futures = {}
    if "3b" in only:
        for label, dim, degree, cells in B1_SHAPES:
            futures[label] = pool.submit(_space, dim, degree, cells, seed=7)
    if "3c" in only:
        for label, dim, degree, _, cells in B2_SHAPES + B2_LEVELS:
            futures[label] = pool.submit(_lattice, dim, degree, cells,
                                         periodic=True)
    pool.shutdown(wait=False)
    return lambda label: futures.pop(label).result()


def phase_kernel_times(torch, device, spaces,
                       parent=None) -> tuple[dict, float]:
    """B1 against plain at its main path's shapes (and, for comparison
    with B2, at the 3D Q1 sizes on a non-affine box): compared first on
    every route, then timed (with the parent's kernel when ``parent`` is
    given).  Returns the times and the worst max-abs error."""
    print("== phase 3b: B1 parity and times at the main path's shapes "
          "(ms)")
    from softx_2020_200_tpu_torch.ops import gls_kernel as gk
    times, worst = {}, 0.0
    for label, dim, degree, cells in B1_SHAPES:
        space = spaces(label)
        _, kernel, plain, forced, parent_fns, state = _variants(
            torch, space, device, seed=3, parent=parent)
        E, reg = space.n_elements, (dim, degree) in gk.REGISTER_SHAPES
        want = _outputs(torch, plain)
        worst = max(worst, _check_settings(torch, label, E, kernel, forced,
                                           want, reg, dim))
        _compare_parent(torch, label, E, parent_fns, want)
        del want
        _time_variants(torch, label, E, kernel, plain, times, parent_fns,
                       _settings(reg, dim), forced)
        worst = max(worst, _time_bf16(torch, label, E, state, times, reg,
                                      dim))
        del kernel, plain, forced, parent_fns, state
        torch.cuda.empty_cache()
    return times, worst


def _time_bf16(torch, label, E, state, times, has_registers,
               dim=None) -> float:
    """The bf16-state tangent and node blocks at a main-path shape: held
    against their plain version on every route, then timed beside the
    float32 ones (the plain version is not timed: it widens the state and
    runs the float32 plain code)."""
    kernel, plain, forced = _bf16_variants(torch, state)
    worst = _check_settings(torch, f"{label} bf16", E, kernel, forced,
                            _outputs(torch, plain), has_registers, dim)
    _time_variants(torch, label, E, kernel, plain, times, None,
                   _settings(has_registers, dim), forced, time_plain=False)
    return worst


def _compare_parent(torch, label, E, parent_fns, want) -> None:
    """The parent's outputs against the plain ones (when there is a
    parent): a check that it is called right, so that its times compare
    like with like."""
    if parent_fns is None:
        return
    for what, fn in parent_fns.items():
        err, rel = _rel(torch, fn(), want[what])
        check(rel < KERNEL_RTOL, f"parent {what} {label}: rel {rel:.3e}")
    print(f"  {label:44s} E={E:7d} parent's kernel within {KERNEL_RTOL:g}")


# ----------------------------------------------------------------------
# phase 3c: B2
# ----------------------------------------------------------------------
def _lattice(dim: int, degree: int, cells, periodic: bool = False,
             shear: float = 0.0):
    """An FE space on a box lattice with unequal spacings per axis, its
    x coordinate sheared by ``shear`` times y (still a lattice of
    translates of one element, but not of a box)."""
    from softx_2020_200_tpu_torch.fem import mesh as M
    from softx_2020_200_tpu_torch.fem.dof import FESpace
    hi = [1.0, 0.7, 1.3][:dim]
    m = M.subdivided_hyper_rectangle([0.0] * dim, hi, list(cells), True,
                                     dim=dim)
    m.vertices[:, 0] += shear * m.vertices[:, 1]
    if periodic:
        m.periodic += [(2 * a, 2 * a + 1, a) for a in range(dim)]
    return FESpace(m, degree)


# B2 parity lattices (dim, degree, Gauss points per axis, cells): 195 and
# 210 cells (E % 4 != 0: 4-byte loads), so each launch spans several
# tiles (32 elements; 16 when there are 27 nodes or points) and ends in a
# ragged one; then 108 and 60 cells (E % 4 == 0, a ragged tile: a
# partial TMA box) and 9 and 12 cells (below one tile).  Q1 with 3 points
# is what the Q1 multigrid levels of a Q2 deck run.
B2_PARITY = tuple(
    (d, k, q, cells)
    for d, k, q in ((2, 1, 2), (2, 2, 3), (3, 1, 2), (3, 2, 3), (2, 1, 3),
                    (3, 1, 3))
    for cells in (((15, 13), (12, 9), (3, 3)) if d == 2 else
                  ((7, 6, 5), (5, 4, 3), (2, 2, 3))))
# B2's main-path shapes (label, dim, degree, Gauss points per axis,
# cells), compared with the plain version and then timed: the TGV
# lattice, the 64^3 box of bench.py, Q2 lattices in 2D (128^2, and the
# MMS deck's 256^2) and 3D, and the two kinds of Q1 level under the MMS
# deck: its p-coarsened level (256^2, 2 points) and the first halved
# level (128^2, which keeps the Q2 deck's 3 points)
B2_SHAPES = (("3D Q1 TGV 32^3", 3, 1, 2, (32,) * 3),
             ("3D Q1 box 64^3", 3, 1, 2, (64,) * 3),
             ("2D Q2 128^2", 2, 2, 3, (128,) * 2),
             ("2D Q2 256^2 (MMS)", 2, 2, 3, (256,) * 2),
             ("3D Q2 32^3", 3, 2, 3, (32,) * 3),
             ("2D Q1 256^2 q=2 (MMS level 1)", 2, 1, 2, (256,) * 2),
             ("2D Q1 128^2 q=3 (MMS level 2)", 2, 1, 3, (128,) * 2))
# a box and then a sheared lattice of the same size (dim, cells), Q1 with
# 2 points per axis: at least 128 elements per SM of the card (16,896 on
# 132 SMs), where the box takes the REGISTERS route; the sheared one has
# a nonzero Laplacian and must stay STAGED.  3D only, and a shear of x
# by 0.02 y, under one cell width over the lattice's height: the lattice
# layout (ops/structured.py) needs the node numbering in lattice order,
# which a 2D shear or a larger one breaks
B2_SHEARED = ((3, (32, 32, 17)),)
B2_SHEAR = 0.02
# the coarser multigrid levels of phases 6, 7 and 11, compared and timed
# too: they carry most of B2's launches on the main path.  The Q1 levels
# with 2 points per axis are the cavity's halved levels and the p-level
# of the MMS deck at refinement 7 (128^2).  The first four are the
# lattice of scripts/run_tgv_torch.py (96^3) and its levels, of which
# phase 16 runs the last three
B2_LEVELS = (("3D Q1 96^3 (TGV driver)", 3, 1, 2, (96,) * 3),
             ("3D Q1 48^3 (phase 16 TGV)", 3, 1, 2, (48,) * 3),
             ("3D Q1 24^3 (phase 16 TGV level 1)", 3, 1, 2, (24,) * 3),
             ("3D Q1 12^3 (phase 16 TGV level 2)", 3, 1, 2, (12,) * 3),
             ("3D Q1 16^3 (TGV level 1)", 3, 1, 2, (16,) * 3),
             ("3D Q1 8^3 (TGV level 2)", 3, 1, 2, (8,) * 3),
             ("2D Q1 64^2 q=3 (MMS level 3)", 2, 1, 3, (64,) * 2),
             ("2D Q1 32^2 q=3 (MMS level 4)", 2, 1, 3, (32,) * 2),
             ("2D Q1 16^2 q=3 (MMS level 5)", 2, 1, 3, (16,) * 2),
             ("2D Q1 128^2 q=2 (cavity level 1)", 2, 1, 2, (128,) * 2),
             ("2D Q1 64^2 q=2 (cavity level 2)", 2, 1, 2, (64,) * 2),
             ("2D Q1 32^2 q=2 (cavity level 3)", 2, 1, 2, (32,) * 2),
             ("2D Q1 16^2 q=2 (cavity level 4)", 2, 1, 2, (16,) * 2))


def _sheared_lattices(torch, device) -> float:
    """B2 with the default route on a box lattice and then on a sheared
    one of the same size, each against its plain version; the box must
    take REGISTERS and the sheared one STAGED, and a REGISTERS launch on
    the sheared tables (``laplacian_free`` 0) must be refused by the
    kernel's entry point."""
    from softx_2020_200_tpu_torch.ops import lattice_kernel as lk
    from softx_2020_200_tpu_torch.ops import persistent_tiles as pt
    worst = 0.0
    for dim, cells in B2_SHEARED:
        for shear in (0.0, B2_SHEAR):
            space = _lattice(dim, 1, cells, shear=shear)
            op, kernel, plain, _, _, state = _variants(
                torch, space, device, seed=dim, n_q1d=2)
            check(op.layout is not None, "B2 sheared lattice took B1")
            k, E = op.kernel, space.n_elements
            label = f"d={dim} k=1 q=2 {'sheared' if shear else 'box'}"
            worst = max(worst, _compare(torch, label, E, kernel, plain))
            kernel, plain, _ = _bf16_variants(torch, state)
            worst = max(worst, _compare(torch, f"{label} bf16", E, kernel,
                                        plain))
            routes = {r for key, (r, _) in k._plans.items()}
            want = pt.STAGED if shear else pt.REGISTERS
            print(f"  {label:44s} E={E:7d} laplacian_free "
                  f"{k.laplacian_free}, routes taken {sorted(routes)}")
            check(k.laplacian_free == (not shear) and routes == {want},
                  f"{label}: routes {routes}, expected {want}")
        # the entry point itself refuses REGISTERS on these tables
        ue = torch.zeros(k.nc * k.nn, E, device=device)
        up = torch.zeros(dim * k.nn, E, device=device)
        fq = torch.zeros(dim * k.nq, E, device=device)
        out = torch.empty_like(ue)
        err = lk.get_build().lib.gls_lattice_launch(
            dim, 1, 2, 1, 4, 4, ue.data_ptr(), ue.data_ptr(), up.data_ptr(),
            fq.data_ptr(), k.tables.data_ptr(), k._host_tables_ptr,
            out.data_ptr(), E, E, k.nu, k.h, 1.5, 20.0, 1, 1, 1, 0, 0, 0,
            pt.REGISTERS, 1, pt.load_path(E, [ue.data_ptr()]),
            int(k.laplacian_free), torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        print(f"  d={dim} sheared: a REGISTERS launch returns CUDA error "
              f"{err}")
        check(err == 1, f"d={dim}: REGISTERS on sheared tables returned "
              f"{err}, not cudaErrorInvalidValue (1)")
    return worst


def phase_lattice_kernel(torch, device, spaces,
                         parent=None) -> tuple[dict, float]:
    from softx_2020_200_tpu_torch.ops import lattice_kernel as lk
    print("== phase 3c: B2 parity (CUDA kernel vs plain PyTorch, float32, "
          f"tolerance {KERNEL_RTOL:g} of the max-abs scale; every route, "
          "both load paths; float32 and bf16 state), a box and a sheared "
          "lattice, then parity and times at the main path's shapes and "
          "levels (ms)")
    worst = 0.0
    for dim, degree, q1d, cells in B2_PARITY:
        space = _lattice(dim, degree, cells)
        for lsic in (False, True):
            op, kernel, plain, forced, _, state = _variants(
                torch, space, device, seed=dim * 10 + degree, lsic=lsic,
                n_q1d=q1d)
            check(op.layout is not None, "B2 parity lattice took B1")
            label = f"d={dim} k={degree} q={q1d}{' lsic' if lsic else ''}"
            reg = (dim, degree, q1d) in lk.REGISTER_SHAPES
            worst = max(worst, _check_settings(
                torch, label, space.n_elements, kernel, forced,
                _outputs(torch, plain), reg))
            worst = max(worst, _check_bf16(torch, label, space.n_elements,
                                           state, reg))
    worst = max(worst, _sheared_lattices(torch, device))
    times = {}
    for label, dim, degree, q1d, cells in B2_SHAPES + B2_LEVELS:
        space = spaces(label)
        op, kernel, plain, forced, parent_fns, state = _variants(
            torch, space, device, seed=5, n_q1d=q1d, parent=parent)
        check(op.layout is not None, f"{label} took B1")
        E, q1 = space.n_elements, (dim, degree, q1d) in lk.REGISTER_SHAPES
        want = _outputs(torch, plain)
        worst = max(worst, _check_settings(torch, label, E, kernel, forced,
                                           want, q1))
        _compare_parent(torch, label, E, parent_fns, want)
        del want
        _time_variants(torch, label, E, kernel, plain, times, parent_fns,
                       _settings(q1), forced)
        worst = max(worst, _time_bf16(torch, label, E, state, times, q1))
        del op, kernel, plain, forced, parent_fns, state
        torch.cuda.empty_cache()
    return times, worst


def _build_of(variant: str) -> tuple[str, int, int]:
    """(mode, state bytes, operand bytes) of a timed variant: "... bf16"
    has bf16 state rows only (the direction and the output f32), "...
    bf16op" every operand and the output in bf16."""
    if variant.endswith(" bf16op"):
        return variant[:-len(" bf16op")], 2, 2
    if variant.endswith(" bf16"):
        return variant[:-len(" bf16")], 2, 4
    return variant, 4, 4


def _bound(dim: int, degree: int, variant: str, E: int, lattice: bool,
           n_q1d: int | None = None):
    """(bound_ms, bound_by) for one call of a variant on E elements (with
    ``n_q1d`` Gauss points per axis, k + 1 by default): the
    bytes that call must move (each input row read once, each output
    written once) over the card's memory rate, against its operations
    over the f32 rate.  Bytes: f32 throughout, but two bf16 kinds at 2
    bytes an element: in a "... bf16" variant (bf16 state) the state rows
    ue, xe, up, fq and h only, the direction and the output staying f32;
    in a "... bf16op" variant (bf16 operands) every input row, the
    direction included, and the output.  Operations count 2 per
    multiply-add of the contractions, and the pointwise physics as
    written in the kernels (about 5d^2 + 14d + 12 a point, 4d^2 + 8d more
    for a tangent); the bf16 builds do the same f32 operations."""
    variant, state_bytes, operand_bytes = _build_of(variant)
    d, n1 = dim, degree + 1
    nn, nq = n1 ** d, (n_q1d or n1) ** d
    c = d + 1
    pw = 5 * d * d + 14 * d + 12
    dpw = 4 * d * d + 8 * d
    if lattice:
        M, Mnl = (d + 2) * nq, (d + 1) * nq
        interp = 2 * nn * (d * M + Mnl + d * nq)       # u, p, u^{n-i}
        proj = 2 * nn * (d * M + Mnl)
        dinterp = 2 * nn * (d * M + Mnl)
        primal_ops = interp + proj + nq * pw
        inputs = c * nn + d * nn + d * nq
    else:
        per_q = (2 * d * d * nn + (45 if d == 3 else 10) + 2 * d ** 3
                 + 2 * nn * d * d + 2 * c * nn * (1 + d) + 2 * c * d * d
                 + 4 * d * nn + pw + 2 * d ** 3 + 2 * d * d
                 + nn * (d * (4 + 2 * d) + 2 + 2 * d))
        dinterp = nq * (2 * c * nn * (1 + d) + 2 * c * d * d + 2 * d * nn)
        primal_ops = nq * per_q
        inputs = c * nn + 2 * d * nn + d * nq + 1     # ue, xe, up, fq, h
    # words besides the state: the output (and the tangent's direction)
    if variant == "primal":
        ops, words = primal_ops, c * nn
    elif variant == "tangent":
        ops, words = primal_ops + dinterp + nq * dpw, 2 * c * nn
    else:   # node blocks: nn*c probes, each without a direction stream
        ops = nn * c * (primal_ops + nq * dpw)
        words = nn * c * c
    return _bound_of(ops, 0, E,
                     nbytes=state_bytes * inputs + operand_bytes * words)


def _bound_of(ops: float, words: float, E: int, nbytes: float | None = None):
    """The bound of ``ops`` operations and ``words`` f32 words (or
    ``nbytes`` bytes) per element, on E elements."""
    nbytes = 4.0 * words if nbytes is None else nbytes
    t_bytes = nbytes * E / PEAK_BYTES_PER_S
    t_ops = float(ops) * E / PEAK_F32_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _gd_ops(dim: int, variant: str, dense: bool = False) -> int:
    """Operations of one element of B3's function (Q2-Q1, 3 Gauss points
    per axis), 2 per multiply-add, plus the pointwise physics as the
    kernel writes it (3d^2 + 6d + 2 a point in the primal, 5d^2 + 4d + 2
    in the tangent).

    Sum-factorized (the default): values and the d reference gradients of
    a velocity component in d passes of 3-term products over 3^(d-1)
    pencils (pass k makes k + 1 fields: 135 multiply-adds in 2D, 729 in
    3D), values alone in d passes (54, 243), the pressure in 2-term
    passes (30, 114); J^-1 on each component's reference gradients and
    on each component's gradient coefficients (d^2 a point each); the
    transposed passes cost what the forward ones do.  The primal
    interpolates u with gradients, p, and u_prev's values, the tangent u
    and du with gradients and dp.  Per element: 2D primal 1,938, tangent
    2,442; 3D primal 14,847, tangent 19,545.

    ``dense``: the same function as products of the dense tables (Tv @ u
    and Pv @ coefficients, Tp @ p and Pp @ div; u_prev through Tv's
    value rows), as counted before the kernel was sum-factorized."""
    d = dim
    nnv, nnp, nq = 3 ** d, 2 ** d, 3 ** d
    mv = (d + 1) * nq
    if dense:
        proj = 2 * d * nnv * mv + 2 * nnp * nq
        if variant == "primal":
            return (2 * d * mv * nnv + 2 * nq * nnp + 2 * d * nq * nnv
                    + proj + nq * (3 * d * d + 6 * d + 2))
        return (4 * d * mv * nnv + 2 * nq * nnp + proj
                + nq * (5 * d * d + 4 * d + 2))
    pencils = 3 ** (d - 1)
    grad = sum(pencils * (k + 1) * 9 for k in range(1, d + 1))
    value = d * pencils * 9
    pres = sum(6 * 3 ** (k - 1) * 2 ** (d - k) for k in range(1, d + 1))
    maps = nq * d * d
    if variant == "primal":
        fma = d * grad + pres + d * value + 2 * d * maps + d * grad + pres
        return 2 * fma + nq * (3 * d * d + 6 * d + 2)
    fma = 2 * d * grad + pres + 3 * d * maps + d * grad + pres
    return 2 * fma + nq * (5 * d * d + 4 * d + 2)


def _bound_gd(dim: int, variant: str, E: int, dense: bool = False):
    """(bound_ms, bound_by) for one call of B3 on E elements: the bytes
    it must move (ue, vpe, fq in, out in the primal; ue, due in, out in
    the tangent; f32, or every row and the output at 2 bytes in a "...
    bf16op" variant: B3 has no bf16-state kind) against the operations of
    its function (``_gd_ops``; ``dense`` counts them as dense products),
    which the bf16 build does in f32 too."""
    d = dim
    variant, _, operand_bytes = _build_of(variant)
    rows = d * 3 ** d + 2 ** d
    words = (2 * rows + 2 * d * 3 ** d if variant == "primal"
             else 3 * rows)
    return _bound_of(_gd_ops(dim, variant, dense), 0, E,
                     nbytes=operand_bytes * words)


# ----------------------------------------------------------------------
# phase 3d: B3
# ----------------------------------------------------------------------
# B3 parity lattices (dim, cells, periodic): 195 and 210 cells (E % 4 !=
# 0: 4-byte loads), several 32-element tiles and a ragged tail, each
# bounded and periodic; 108 and 60 cells (E % 4 == 0, a ragged tile: a
# partial TMA box); 9 and 12 cells (below one tile)
B3_PARITY = ((2, (15, 13), False), (2, (15, 13), True),
             (3, (7, 6, 5), False), (3, (7, 6, 5), True),
             (2, (12, 9), False), (3, (5, 4, 3), False),
             (2, (3, 3), False), (3, (2, 2, 3), False))
# a sheared 3D lattice (x moved by B2_SHEAR times y) that the GD operator
# still takes as a lattice of translates: J^-1 is not diagonal
B3_SHEARED = (3, (8, 8, 5))
# B3's main-path shapes (label, dim, cells): the GD cavity of phase 8,
# the GD Taylor-Green deck of phase 9 and the example's own 32^3; and 2D
# 128^2 (124 elements per SM on 132 SMs), just below where the default
# route turns to REGISTERS, timed on both routes
B3_SHAPES = (("2D Q2-Q1 256^2 (GD cavity)", 2, (256,) * 2),
             ("3D Q2-Q1 16^3 (GD TGV)", 3, (16,) * 3),
             ("3D Q2-Q1 32^3", 3, (32,) * 3),
             ("2D Q2-Q1 128^2", 2, (128,) * 2))


def _gd_variants(torch, dim, cells, periodic, device, seed, shear=0.0,
                 parent=None):
    """(operator, kernel calls, plain calls, forced, parent's calls) of
    B3 on a lattice with seeded float32 state: the primal residual and
    the exact tangent (the plain tangent by forward-mode AD);
    ``forced(route)`` gives the kernel's calls on a forced route; the
    parent's calls (its own wrapper on the same tables and inputs) are
    None without ``parent``."""
    op = _gd_operator(torch, dim, cells, periodic, device, torch.float32,
                      shear)
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, s=1.0):
        return (s * torch.randn(*shape, generator=g, dtype=torch.float64)
                ).to(device, torch.float32)

    E = op.space_v.n_elements
    ue = op._rows(rnd(op.n_dofs, s=0.3))
    due = op._rows(rnd(op.n_dofs))
    vpe = op._vrows(rnd(op.Nv, dim, s=0.2))
    fq = op._fq_rows(rnd(E, op.n_q, dim, s=0.1))
    k, a0 = op.kernel, 1.5
    plain = k.plain()
    kernel = {"primal": lambda: k.residual(ue, vpe, fq, a0),
              "tangent": lambda: k.tangent(ue, due, a0)}
    ref = {"primal": lambda: plain(ue, vpe, fq, a0),
           "tangent": lambda: torch.func.jvp(
               lambda v: plain(v, None, None, a0), (ue,), (due,))[1]}

    def forced(route, split=None):
        return {"primal": lambda: k._call(0, ue, None, vpe, fq, a0, route),
                "tangent": lambda: k._call(1, ue, due, None, None, a0,
                                           route)}

    parent_fns = None
    if parent is not None and op.layout_v is not None:
        _, w, Bv, Gv, _ = op.space_v.basis.quadrature(3)
        _, _, Bp, _, _ = op.space_p.basis.quadrature(3)
        pk = parent.lattice_gd_kernel.LatticeGDKernel(
            dim=dim, degree_pressure=1, Bv=Bv, Gv=Gv, Bp=Bp, w=w,
            xe0=op.layout_v.elem_coords_grid_order()[0], nu=k.nu,
            gamma=k.gamma, dtype=torch.float32, device=device)
        parent_fns = {"primal": lambda: pk.residual(ue, vpe, fq, a0),
                      "tangent": lambda: pk.tangent(ue, due, a0)}
    return op, kernel, ref, forced, parent_fns


def phase_gd_kernel(torch, device, parent=None) -> tuple[dict, float]:
    import numpy as np
    from softx_2020_200_tpu_torch.ops import lattice_gd_kernel as gk
    from softx_2020_200_tpu_torch.ops import persistent_tiles as pt
    print("== phase 3d: B3 parity (CUDA kernel vs plain PyTorch, float32, "
          f"tolerance {KERNEL_RTOL:g} of the max-abs scale; every route, "
          "both load paths), a sheared lattice, then parity and times at "
          "the main path's shapes (ms)")
    worst = 0.0
    for dim, cells, periodic in B3_PARITY:
        op, kernel, plain, forced, _ = _gd_variants(torch, dim, cells,
                                                    periodic, device, seed=dim)
        check(op.layout_v is not None, "B3 parity lattice took SoA")
        label = f"d={dim} Q2-Q1{' periodic' if periodic else ''}"
        worst = max(worst, _check_settings(
            torch, label, op.space_v.n_elements, kernel, forced,
            _outputs(torch, plain), dim in gk.REGISTER_DIMS))
    dim, cells = B3_SHEARED
    op, kernel, plain, forced, _ = _gd_variants(
        torch, dim, cells, False, device, seed=4, shear=B2_SHEAR)
    check(op.layout_v is not None, "B3 sheared lattice took SoA")
    Jinv = op.kernel.geometry[0]
    off_diag = float(np.abs(Jinv - np.diag(np.diag(Jinv))).max())
    print(f"  d={dim} sheared lattice: off-diagonal |J^-1| {off_diag:.3e}")
    check(off_diag > 0, "B3 sheared lattice has a diagonal J^-1")
    worst = max(worst, _check_settings(
        torch, f"d={dim} Q2-Q1 sheared", op.space_v.n_elements, kernel,
        forced, _outputs(torch, plain), False))
    # the entry point refuses a route that is not compiled (REGISTERS in
    # 3D) with cudaErrorInvalidValue, and the launch never runs
    k, E = op.kernel, op.space_v.n_elements
    ue = torch.zeros(k.rows, E, device=device)
    out = torch.empty_like(ue)
    err = gk.get_build().lib.gd_lattice_launch(
        dim, 1, 1, 4, ue.data_ptr(), ue.data_ptr(), None, None,
        k._host_tables_ptr, out.data_ptr(), E, E, k.nu, k.gamma, 1.5,
        pt.REGISTERS, 1, pt.load_path(E, [ue.data_ptr()]),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    print(f"  d={dim}: a REGISTERS launch returns CUDA error {err}")
    check(err == 1, f"d={dim}: REGISTERS launch returned {err}, not "
          "cudaErrorInvalidValue (1)")
    times = {}
    for label, dim, cells in B3_SHAPES:
        op, kernel, plain, forced, parent_fns = _gd_variants(
            torch, dim, cells, True, device, seed=5, parent=parent)
        check(op.layout_v is not None, f"{label} took the SoA path")
        E = op.space_v.n_elements
        want = _outputs(torch, plain)
        worst = max(worst, _check_settings(torch, label, E, kernel, forced,
                                           want, dim in gk.REGISTER_DIMS))
        _compare_parent(torch, label, E, parent_fns, want)
        del want
        _time_variants(torch, label, E, kernel, plain, times, parent_fns,
                       _settings(dim in gk.REGISTER_DIMS), forced)
        routes = {gk.ROUTE_NAMES[r] for (_, _, route), (r, _) in
                  op.kernel._plans.items() if route == "auto"}
        times[label]["routes"] = sorted(routes)
        print(f"  {label:32s} E={E:7d} default route {sorted(routes)} "
              f"({pt.sm_count(device)} SMs)")
        del op, kernel, plain, forced, parent_fns
        torch.cuda.empty_cache()
    return times, worst


# ----------------------------------------------------------------------
# phases 4-9
# ----------------------------------------------------------------------
_NUM = r"([-+]?\d+\.?\d*(?:[eE][-+]?\d+)?)"
KERNELS = ("gls_element", "gls_lattice", "gd_lattice")


def _launch_counters():
    from softx_2020_200_tpu_torch.ops.gls_kernel import GLSElementKernel
    from softx_2020_200_tpu_torch.ops.lattice_gd_kernel import \
        LatticeGDKernel
    from softx_2020_200_tpu_torch.ops.lattice_kernel import LatticeGLSKernel
    return {"gls_element": GLSElementKernel,
            "gls_lattice": LatticeGLSKernel,
            "gd_lattice": LatticeGDKernel}


@contextlib.contextmanager
def _engine_kept(solver: str, engines: list):
    """The app's ``solver`` engine class, made to append every engine it
    builds to ``engines``, each keeping what its ``solve()`` returns as
    ``final`` (to read the final solution after a run)."""
    from softx_2020_200_tpu_torch.apps import common
    cls = common.SOLVERS[solver]

    def build(*args, **kwargs):
        engine = cls(*args, **kwargs)
        solve = engine.solve

        def kept(*a, **kw):
            engine.final = solve(*a, **kw)
            return engine.final

        engine.solve = kept
        engines.append(engine)
        return engine

    common.SOLVERS[solver] = build
    try:
        yield
    finally:
        common.SOLVERS[solver] = cls


@contextlib.contextmanager
def _b1_states(store: dict):
    """Records in ``store``, for every (dim, degree, points per axis, E)
    at which B1 launches inside the block, the kernel object and a copy
    of the inputs of its first launch there (ue, xe, up, fq, h, alpha0,
    sdt): the geometry and state of the operator that launched it, for
    the pass after the run that compares and times B1 at that shape.
    Launch counting is the wrapper's own and is left as it is."""
    from softx_2020_200_tpu_torch.ops.gls_kernel import GLSElementKernel
    launch = GLSElementKernel._launch

    def recording(self, mode, ue, due, args, out, *rest, **kw):
        key = (self.dim, self.degree, self.q1d, ue.shape[-1])
        if key not in store:
            store[key] = (self, ue.clone(),
                          tuple(a.clone() if hasattr(a, "clone") else a
                                for a in args))
        return launch(self, mode, ue, due, args, out, *rest, **kw)

    GLSElementKernel._launch = recording
    try:
        yield
    finally:
        GLSElementKernel._launch = launch


@contextlib.contextmanager
def _shard_reports(reports: list):
    """Appends to ``reports`` the ``shard_report()`` of every sharded
    solver the apps wire inside the block (per shard owned and ghost
    nodes, bytes per refresh)."""
    from softx_2020_200_tpu_torch.parallel.sharded import ShardedGLSSolver
    from softx_2020_200_tpu_torch.parallel.sharded_gd import ShardedGDSolver
    saved = {cls: cls.__dict__["from_solver"]
             for cls in (ShardedGLSSolver, ShardedGDSolver)}

    def wrapped(inner):
        def from_solver(cls, *args, **kwargs):
            sh = inner.__func__(cls, *args, **kwargs)
            reports.append(sh.shard_report())
            return sh
        return classmethod(from_solver)

    for cls, inner in saved.items():
        cls.from_solver = wrapped(inner)
    try:
        yield
    finally:
        for cls, inner in saved.items():
            cls.from_solver = inner


def drive_app(torch, dim: int, deck: str, kernel: str | None,
              solver: str = "gls", workdir: str | None = None,
              engines: list | None = None,
              b1_states: dict | None = None,
              devices: list | None = None) -> dict:
    """Run the deck through the port's CLI entry point on the card (the
    ``solver`` app: ``gls`` or ``gd``) in ``workdir`` (a new temporary
    directory by default); its output is echoed and returned with the
    launch counts and memory.  Checks that it launched ``kernel`` (None:
    none of the kernels) and no other.  ``engines`` collects the engine
    the app builds; ``b1_states`` records B1's launch states per shape
    (``_b1_states``); ``devices`` shards the run over them (phase 13),
    and the result's ``shards`` holds each sharded solver's report."""
    from softx_2020_200_tpu_torch.apps.common import run_app
    reports = []
    with contextlib.ExitStack() as stack:
        if engines is not None:
            stack.enter_context(_engine_kept(solver, engines))
        if b1_states is not None:
            stack.enter_context(_b1_states(b1_states))
        if devices is not None:
            stack.enter_context(_shard_reports(reports))
        tmp = workdir or stack.enter_context(tempfile.TemporaryDirectory())
        path = os.path.join(tmp, deck)
        with open(path, "w") as fh:
            fh.write(deck_text(deck))
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            rc, out, seconds, launches, by_shape = _counted(
                torch, lambda: run_app(dim, [path], solver=solver,
                                       device="cuda", dtype=torch.float32,
                                       devices=devices))
        finally:
            os.chdir(cwd)
    check(rc == 0, f"{deck}: app returned {rc}")
    check("GMG stagnated" not in out,
          f"{deck}: multigrid stagnated and fell back to block-Jacobi")
    stats = re.search(
        rf"Newton summary: {_NUM} solves, {_NUM} iterations, {_NUM} "
        rf"linear iterations, {_NUM} s per Newton iteration, {_NUM} host "
        rf"syncs per Newton iteration, {_NUM} line-search evaluations, "
        rf"{_NUM} Krylov restarts, {_NUM} solves above tolerance", out)
    check(stats is not None, f"{deck}: no Newton summary line")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    res = dict(deck=deck, out=out, seconds=seconds, launches=launches,
               launches_by_shape=by_shape, peak_mib=peak, shards=reports,
               newton_solves=int(stats.group(1)),
               newton_iterations=int(stats.group(2)),
               linear_iterations=int(stats.group(3)),
               s_per_newton=float(stats.group(4)),
               syncs_per_newton=float(stats.group(5)),
               line_search_evaluations=int(stats.group(6)),
               linear_restarts=int(stats.group(7)),
               solves_above_tolerance=int(stats.group(8)))
    print(f"  wall {seconds:.2f} s, Newton iterations "
          f"{res['newton_iterations']}, linear iterations "
          f"{res['linear_iterations']}, {res['s_per_newton']:.4f} s per "
          f"Newton iteration, {res['syncs_per_newton']:.1f} host syncs per "
          f"Newton iteration, peak device memory {peak:.1f} MiB, launches "
          f"{launches}")
    _check_launched(deck, launches, kernel)
    return res


def _counted(torch, call):
    """``call()`` with its standard output captured and echoed, and every
    kernel's launch count set to 0 just before it: (its value, the
    output, seconds, launches per kernel, launches per kernel and
    shape).  Resets the peak device memory too."""
    counters = _launch_counters()
    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for cls in counters.values():
        cls.launches = 0
        cls.launches_by_shape = {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        value = call()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"  | {line}")
    return (value, out, seconds,
            {name: cls.launches for name, cls in counters.items()},
            {name: dict(cls.launches_by_shape)
             for name, cls in counters.items()})


def _check_launched(label: str, launches: dict, kernel: str | None):
    """``kernel`` launched (None: no kernel) and no other."""
    for name in KERNELS:
        if name == kernel:
            check(launches[name] > 0, f"{label}: {name} was never launched")
        else:
            check(launches[name] == 0, f"{label}: {name} was launched "
                  f"{launches[name]} times")


def _close(got: float, want: float, rtol: float) -> bool:
    return abs(got - want) <= rtol * abs(want)


def _l2_errors(deck: str, out: str) -> tuple[float, float]:
    m = re.findall(rf"L2 error velocity : {_NUM}  L2 error pressure: {_NUM}",
                   out)
    check(len(m) == 1, f"{deck}: expected one L2 line, found {len(m)}")
    return float(m[0][0]), float(m[0][1])


def phase_couette(torch) -> list[dict]:
    print("== phase 4: main path on B1, 2D steady Taylor-Couette (Q2, "
          "curved shell, block-Jacobi), refinement 3 against JAX")
    deck = "taylor_couette_r3.prm"
    r3 = drive_app(torch, 2, deck, "gls_element")
    _check_converged(deck, r3)
    _check_l2(deck, r3["out"], JAX_REFERENCE[deck])
    return [r3]


def _check_l2(deck: str, out: str, ref: dict) -> None:
    """The deck's L2 errors against the JAX package's ``ref``."""
    errors = dict(zip(("velocity", "pressure"), _l2_errors(deck, out)))
    for what, got in errors.items():
        want = ref[f"l2_{what}"]
        print(f"  L2 error {what}: card f32 {got:.8e}, JAX CPU f64 "
              f"{want:.8e}, rel diff {abs(got - want) / want:.3e} (bound "
              f"{L2_RTOL:g})")
        check(_close(got, want, L2_RTOL),
              f"{deck}: L2 error {what} {got} vs reference {want}")


def _check_converged(deck: str, res: dict) -> None:
    """Every Newton solve of the run reached the deck's tolerance."""
    print(f"  solves above tolerance: {res['solves_above_tolerance']} of "
          f"{res['newton_solves']}")
    check(res["solves_above_tolerance"] == 0,
          f"{deck}: {res['solves_above_tolerance']} Newton solves ended "
          "above their tolerance")


def _tgv(torch, deck: str) -> dict:
    res = drive_app(torch, 3, deck, "gls_lattice")
    _check_energies(deck, res["out"])
    return res


def _check_energies(deck: str, out: str, ref_deck: str | None = None) -> None:
    """KE and enstrophy per step against the JAX package's (on
    ``ref_deck``, the deck itself by default)."""
    m = re.findall(rf"kinetic-energy: {_NUM}  enstrophy: {_NUM}", out)
    ref = JAX_REFERENCE[ref_deck or deck]
    check(len(m) == len(ref["kinetic_energy"]),
          f"{deck}: expected {len(ref['kinetic_energy'])} steps, found "
          f"{len(m)}")
    for step, ((ke, en), ke_ref, en_ref) in enumerate(
            zip(m, ref["kinetic_energy"], ref["enstrophy"]), start=1):
        ke, en = float(ke), float(en)
        print(f"  step {step}: KE {ke:.6e} (JAX {ke_ref:.6e}), enstrophy "
              f"{en:.6e} (JAX {en_ref:.6e})")
        check(_close(ke, ke_ref, ENERGY_RTOL), f"step {step}: KE {ke}")
        check(_close(en, en_ref, ENERGY_RTOL), f"step {step}: enstrophy "
              f"{en}")


def phase_tgv(torch) -> dict:
    print("== phase 5: main path on B2, 3D transient TGV (Q1, periodic "
          "32^3, BDF2, 3 steps, block-Jacobi)")
    return _tgv(torch, "tgv32_3steps.prm")


def _gmg_levels(deck: str, out: str) -> int:
    m = re.search(r"preconditioner 'auto' resolves to gmg \((\d+) levels\)",
                  out)
    check(m is not None, f"{deck}: 'auto' did not resolve to gmg")
    return int(m.group(1))


def _vcycle_alone(torch, deck: str) -> float:
    """Build the deck's solver on the card, apply one multigrid cycle
    with every CUDA synchronisation made an error, and time it.  Returns
    the median ms of one application."""
    from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
    from softx_2020_200_tpu_torch.solvers.base import GLSNavierStokesSolver
    with tempfile.TemporaryDirectory() as tmp:
        text = deck_text(deck).replace(
            "subsection simulation control\n",
            f"subsection simulation control\n  set output path = {tmp}/\n",
            1)
        with contextlib.redirect_stdout(io.StringIO()):
            solver = GLSNavierStokesSolver(
                SimulationParameters.from_text(text, dim=3),
                device="cuda", dtype=torch.float32)
            u0 = solver.initial_condition()
        dt = solver.control.dt
        problem = solver._make_problem(solver._zero_prev, dt, 1.0 / dt,
                                       1.0 / dt)
        apply = problem[4](u0)          # the cycle's state, built once
        v = torch.randn(u0.shape, device="cuda", dtype=torch.float32,
                        generator=torch.Generator("cuda").manual_seed(1))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            z = apply(v)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(bool(torch.isfinite(z).all()), f"{deck}: V-cycle not finite")
        ms = _median_ms(torch, lambda: apply(v), reps=10)
    print(f"  one V-cycle applied with CUDA synchronisation an error: no "
          f"sync; {ms:.3f} ms per application")
    return ms


def phase_tgv_gmg(torch) -> dict:
    print("== phase 6: main path on B2, TGV 32^3 with 'auto': geometric "
          "multigrid, FGMRES")
    deck = "tgv32_gmg.prm"
    res = _tgv(torch, deck)
    levels = _gmg_levels(deck, res["out"])
    print(f"  multigrid levels: {levels}")
    check(levels == 3, f"{deck}: {levels} multigrid levels, not 3")
    # a cycle that works takes as many FGMRES steps as the JAX package's
    # (block-Jacobi GMRES takes 14.1 per Newton iteration on this deck)
    its = res["newton_iterations"]
    lin = res["linear_iterations"] / its
    want = JAX_REFERENCE[deck]["fgmres_per_newton"]
    print(f"  FGMRES iterations per Newton iteration {lin:.2f} (JAX CPU f64 "
          f"{want:.2f}, bound +-1)")
    check(abs(lin - want) <= 1.0, f"{deck}: {lin:.2f} FGMRES iterations "
          f"per Newton iteration against {want:.2f}")
    _check_syncs(deck, res)
    res["vcycle_ms"] = _vcycle_alone(torch, deck)
    return res


def _check_syncs(deck: str, res: dict) -> None:
    """The host reads are the solver loop's own: the first residual of
    each solve, the first residual of each FGMRES solve, one per FGMRES
    step, one per Krylov restart and one per line-search evaluation; the
    multigrid cycle adds none."""
    its = res["newton_iterations"]
    reads = (res["newton_solves"] + its + res["linear_iterations"]
             + res["linear_restarts"] + res["line_search_evaluations"])
    syncs = res["syncs_per_newton"] * its
    print(f"  host syncs {syncs:.0f} against the solver loop's {reads} "
          f"reads ({res['newton_solves']} solves, {its} Newton iterations, "
          f"{res['linear_iterations']} FGMRES steps, "
          f"{res['linear_restarts']} restarts, "
          f"{res['line_search_evaluations']} line-search evaluations)")
    check(round(syncs) == reads, f"{deck}: {syncs:.0f} host syncs, not "
          f"{reads}: the cycle syncs")


def phase_mms_gmg(torch) -> dict:
    print("== phase 7: main path on B2, Q2 lattice MMS (256^2, BDF2, 3 "
          "steps) with 'auto': p- then h-multigrid")
    deck = "mms_q2_r8.prm"
    res = drive_app(torch, 2, deck, "gls_lattice")
    levels = _gmg_levels(deck, res["out"])
    print(f"  multigrid levels: {levels}")
    check(levels == 6, f"{deck}: {levels} multigrid levels, not 6")
    _check_converged(deck, res)
    got = [float(x) for x in re.findall(rf"L2 error velocity : {_NUM}\n",
                                        res["out"])]
    want = JAX_REFERENCE[deck]["l2_velocity"]
    check(len(got) == len(want), f"{deck}: {len(got)} L2 lines")
    for step, (g, w) in enumerate(zip(got, want), start=1):
        print(f"  step {step}: L2 error velocity card f32 {g:.8e}, JAX CPU "
              f"f64 {w:.8e}, rel diff {abs(g - w) / w:.3e} (bound "
              f"{L2_RTOL:g})")
        check(_close(g, w, L2_RTOL), f"{deck} step {step}: L2 {g} vs {w}")
    return res


def phase_gd_cavity(torch) -> dict:
    print("== phase 8: main path on B3, 2D steady GD cavity (Q2-Q1, 256^2) "
          "with 'auto': velocity-block multigrid, FGMRES")
    deck = "gd_cavity_r8.prm"
    res = drive_app(torch, 2, deck, "gd_lattice", solver="gd")
    levels = _gmg_levels(deck, res["out"])
    print(f"  multigrid levels: {levels}")
    check(levels == 6, f"{deck}: {levels} multigrid levels, not 6")
    # the JAX GD engine has no fallback to block-Jacobi: a weak cycle
    # shows as a solve that ends above its tolerance
    check(res["solves_above_tolerance"] == 0,
          f"{deck}: {res['solves_above_tolerance']} Newton solves ended "
          "above their tolerance")
    forces = re.findall(rf"Force boundary (\d+) : {_NUM} {_NUM}\n",
                        res["out"])
    want = JAX_REFERENCE[deck]["forces"]
    check(len(forces) == len(want), f"{deck}: {len(forces)} force lines")
    for bid, fx, fy in forces:
        got, ref = (float(fx), float(fy)), want[int(bid)]
        rel = (max(abs(g - r) for g, r in zip(got, ref))
               / max(abs(r) for r in ref))
        print(f"  force on boundary {bid}: card f32 ({got[0]:.8e}, "
              f"{got[1]:.8e}), JAX CPU f64 ({ref[0]:.8e}, {ref[1]:.8e}), "
              f"rel diff {rel:.3e} (bound {FORCE_RTOL:g})")
        check(rel <= FORCE_RTOL, f"{deck}: force on boundary {bid} {got} "
              f"vs {ref}")
    lin = res["linear_iterations"] / res["newton_iterations"]
    want = JAX_REFERENCE[deck]["fgmres_per_newton"]
    print(f"  FGMRES iterations per Newton iteration {lin:.2f} (JAX CPU f64 "
          f"{want:.2f}, bound {FGMRES_RTOL:.0%})")
    check(_close(lin, want, FGMRES_RTOL), f"{deck}: {lin:.2f} FGMRES "
          f"iterations per Newton iteration against {want:.2f}")
    _check_syncs(deck, res)
    return res


def phase_gd_tgv(torch) -> dict:
    print("== phase 9: main path on B3, 3D transient GD Taylor-Green "
          "(Q2-Q1, periodic 16^3, BDF2, 2 steps) with 'auto'")
    deck = "tgv16_gd.prm"
    res = drive_app(torch, 3, deck, "gd_lattice", solver="gd")
    _check_energies(deck, res["out"])
    levels = _gmg_levels(deck, res["out"])
    print(f"  multigrid levels: {levels}")
    check(levels == 3, f"{deck}: {levels} multigrid levels, not 3")
    check(res["solves_above_tolerance"] == 0,
          f"{deck}: {res['solves_above_tolerance']} Newton solves ended "
          "above their tolerance")
    # not held: in float32 the linear solves of this deck take 2-3x the
    # f64 count (the port on the CPU: 127 and 71 FGMRES iterations in
    # the first two solves in f32, 67 and 59 in f64, which are the JAX
    # package's); the cycle is held on the cavity and in the CPU tests
    lin = res["linear_iterations"] / res["newton_iterations"]
    print(f"  FGMRES iterations per Newton iteration {lin:.2f} (JAX CPU f64 "
          f"{JAX_REFERENCE[deck]['fgmres_per_newton']:.2f}; not held)")
    _check_syncs(deck, res)
    return res


def _tangent_distance(torch, deck: str, dim: int) -> None:
    """The bf16-state tangent and node blocks against the float32-state
    ones (both the frozen-tau kernels) on the deck's mesh, at its
    analytical solution (a steady state) along a seeded direction: the
    relative max-abs distance (ROADMAP C5: B1 rounds the element
    coordinates too)."""
    from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
    from softx_2020_200_tpu_torch.solvers.base import GLSNavierStokesSolver
    from softx_2020_200_tpu_torch.solvers.gls import GLSOperator
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(io.StringIO()):
        text = deck_text(deck).replace(
            "subsection simulation control\n",
            f"subsection simulation control\n  set output path = {tmp}/\n",
            1)
        solver = GLSNavierStokesSolver(
            SimulationParameters.from_text(text, dim=dim), device="cuda",
            dtype=torch.float32)
    op32 = solver.op
    op16 = GLSOperator(solver.space, op32.nu, n_q1d=solver.prm.fem
                       .n_quadrature_points_1d, stab=op32.stab,
                       state_dtype=torch.bfloat16, dtype=torch.float32,
                       device="cuda")
    c = op32.nc
    u = solver.exact.spatial(solver.bh.node_coords, 0.0)[:, :c].contiguous()
    g = torch.Generator("cuda").manual_seed(2)
    v = torch.randn(u.shape, device="cuda", generator=g)
    prev = torch.zeros(u.shape[0], dim, device="cuda")
    fq = torch.zeros(op32.space.n_elements, op32.n_q, dim, device="cuda")
    mask = torch.zeros(u.shape, dtype=torch.bool, device="cuda")
    out = {}
    d32 = op32.jvp(op32.linearize(u, prev, fq, 0.0, 0.0), v)
    d16 = op16.jvp(op16.linearize(u, prev, fq, 0.0, 0.0), v)
    out["tangent"] = _rel(torch, d16, d32)[1]
    b32 = op32.node_blocks(u, mask, prev, fq, 0.0, 0.0)
    b16 = op16.node_blocks(u, mask, prev, fq, 0.0, 0.0)
    out["node blocks"] = _rel(torch, b16, b32)[1]
    print(f"  {deck}: bf16 against float32 state at the analytical "
          f"solution, rel max-abs distance: tangent {out['tangent']:.3e}, "
          f"node blocks {out['node blocks']:.3e}")
    # a measurement (ROADMAP C5), held only to be finite and nonzero: on
    # a fine curved mesh the rounded coordinates move J by a large share
    check(all(0 < r < float("inf") for r in out.values()),
          f"{deck}: bf16 tangent distance {out}")


def phase_bf16_decks(torch, f32_runs: dict) -> tuple[list, list]:
    """Phase 10: the decks of phases 4-6 with the bf16 Jacobian state,
    each beside its float32 run (``f32_runs`` by deck; run here when
    missing): only the bf16 tangent and probe variants launch, the
    physics stays inside the float32 phases' bounds, and Newton takes at
    most one iteration more (on B1's curved shell: the JAX package's bf16
    count, +-1); then the bf16 tangent's distance to the float32 one at
    Taylor-Couette r3 and r5.  Returns the B1 and the B2 runs."""
    print("== phase 10: the bf16 Jacobian state on the main path "
          "(jacobian state precision = bf16): TC r3 on B1, TGV 32^3 "
          "block-Jacobi and GMG on B2, each beside its float32 run")
    b1_runs, b2_runs = [], []
    for deck, dim in BF16_DECKS.items():
        kernel = "gls_element" if dim == 2 else "gls_lattice"
        f32 = f32_runs.get(deck) or drive_app(torch, dim, deck, kernel)
        name = deck.replace(".prm", "_bf16.prm")
        res = drive_app(torch, dim, name, kernel)
        (b1_runs if dim == 2 else b2_runs).append(res)
        by_mode = {}
        for key, n in res["launches_by_shape"][kernel].items():
            by_mode[key[4]] = by_mode.get(key[4], 0) + n
        print(f"  {name}: launches per variant {by_mode}")
        check(by_mode.get("tangent_bf16", 0) > 0
              and by_mode.get("probe_bf16", 0) > 0
              and by_mode.get("tangent", 0) == 0
              and by_mode.get("probe", 0) == 0,
              f"{name}: launches {by_mode}, not the bf16 tangent and probe")
        for tag, r in (("f32 ", f32), ("bf16", res)):
            print(f"  {tag} {r['deck']:26s} Newton {r['newton_iterations']:3d}"
                  f", Krylov {r['linear_iterations']:6d}, solves above "
                  f"tolerance {r['solves_above_tolerance']} of "
                  f"{r['newton_solves']}, {r['s_per_newton']:.4f} s per "
                  "Newton iteration")
        # Newton: at most one iteration more than float32; on B1's curved
        # shell, where the rounded coordinates cost iterations in both
        # packages (ROADMAP C5), within one of the JAX package's count
        # with the bf16 state
        ref = JAX_REFERENCE.get(name, {}).get("newton_iterations")
        want = (ref if ref is not None else f32["newton_iterations"])
        print(f"  Newton iterations {res['newton_iterations']}: held to "
              + (f"the JAX package's {ref} with the bf16 state +-1"
                 if ref is not None else
                 f"float32's {f32['newton_iterations']} + 1"))
        check(res["newton_iterations"] <= want + 1
              and (ref is None or res["newton_iterations"] >= ref - 1),
              f"{name}: {res['newton_iterations']} Newton iterations "
              f"against {want}")
        if dim == 2:
            _check_l2(name, res["out"], JAX_REFERENCE[deck])
        else:
            _check_energies(name, res["out"], deck)
    for deck in ("taylor_couette_r3.prm", "taylor_couette_r5.prm"):
        _tangent_distance(torch, deck, 2)
    return b1_runs, b2_runs


# ----------------------------------------------------------------------
# phase 11: SDIRK, pseudo-transient continuation, checkpoint/restart and
# additive Schwarz
# ----------------------------------------------------------------------
# Newton and linear iterations of each solve, from the lines a GLS deck
# with verbose Newton prints
_PER_SOLVE = re.compile(r"^Newton: (\d+) iterations, (\d+) linear "
                        r"iterations", re.M)
# additive Schwarz: Krylov iterations per Newton iteration against the
# JAX package's with tau frozen, relative
AS_KRYLOV_RTOL = 0.10
# the restarted leg against the uninterrupted run, relative (the same
# float32 computation, printed to 7 digits)
RESTART_RTOL = 1e-6
# the pseudo-transient continuation on the cavity: pseudo-steps within 1
# and Krylov iterations within 10 % of the JAX package's
PTC_KRYLOV_RTOL = 0.10


def _per_solve(deck: str, out: str, n: int | None = None) -> list:
    m = [(int(a), int(b)) for a, b in _PER_SOLVE.findall(out)]
    check(n is None or len(m) == n, f"{deck}: {len(m)} solves, not {n}")
    return m


def _check_newton_per_solve(deck: str, res: dict) -> None:
    """Each solve's Newton iterations equal the JAX package's, its
    linear iterations within 1 per Newton iteration (the reference's
    precision as JAX_REFERENCE's comment on the deck says)."""
    ref = JAX_REFERENCE[deck]
    got = _per_solve(deck, res["out"], len(ref["newton_per_solve"]))
    print(f"  Newton iterations per solve {[n for n, _ in got]} (JAX CPU "
          f"{ref['newton_per_solve']}), linear iterations per solve "
          f"{[k for _, k in got]} (JAX {ref.get('krylov_per_solve')})")
    border = ref.get("newton_borderline", ())
    for i, ((n, k), nr, kr) in enumerate(zip(got, ref["newton_per_solve"],
                                             ref["krylov_per_solve"])):
        check(n == nr or (i in border and abs(n - nr) == 1),
              f"{deck}: solve {i + 1}: {n} Newton iterations against {nr}")
        check(abs(k - kr) <= max(n, nr), f"{deck}: solve {i + 1}: {k} "
              f"linear iterations against {kr}")
    _check_converged(deck, res)


def _sdirk(torch) -> list:
    runs = []
    deck = "tgv32_sdirk2.prm"
    res = drive_app(torch, 3, deck, "gls_lattice")
    _check_energies(deck, res["out"])
    _check_newton_per_solve(deck, res)
    runs.append(res)
    deck = "mms_q2_r7_sdirk3.prm"
    res = drive_app(torch, 2, deck, "gls_lattice")
    check(_gmg_levels(deck, res["out"]) == 5, f"{deck}: not 5 levels")
    _check_newton_per_solve(deck, res)
    got = [float(x) for x in re.findall(rf"L2 error velocity : {_NUM}\n",
                                        res["out"])]
    want = JAX_REFERENCE[deck]["l2_velocity"]
    check(len(got) == len(want), f"{deck}: {len(got)} L2 lines")
    for step, (g, w) in enumerate(zip(got, want), start=1):
        print(f"  step {step}: L2 error velocity card f32 {g:.8e}, JAX CPU "
              f"f64 {w:.8e}, rel diff {abs(g - w) / w:.3e} (bound "
              f"{L2_RTOL:g})")
        check(_close(g, w, L2_RTOL), f"{deck} step {step}: L2 {g} vs {w}")
    runs.append(res)
    return runs


def _gd_sdirk(torch) -> dict:
    deck = "tgv16_gd_sdirk2.prm"
    res = drive_app(torch, 3, deck, "gd_lattice", solver="gd")
    _check_energies(deck, res["out"])
    ref = JAX_REFERENCE[deck]
    print(f"  {res['newton_solves']} solves, {res['newton_iterations']} "
          f"Newton iterations (JAX CPU f64 {ref['newton_solves']}, "
          f"{ref['newton_iterations']}); FGMRES iterations per Newton "
          f"iteration {res['linear_iterations'] / res['newton_iterations']:.2f}"
          f" (JAX {ref['fgmres_per_newton']:.2f}; not held, as in phase 9)")
    check(res["newton_solves"] == ref["newton_solves"]
          and res["newton_iterations"] == ref["newton_iterations"],
          f"{deck}: {res['newton_solves']} solves, "
          f"{res['newton_iterations']} Newton iterations")
    check(res["solves_above_tolerance"] == 0,
          f"{deck}: {res['solves_above_tolerance']} solves above tolerance")
    return res


def _ptc(torch) -> dict:
    deck = "cavity_ptc.prm"
    res = drive_app(torch, 2, deck, "gls_lattice")
    ref = JAX_REFERENCE[deck]
    steps = res["newton_iterations"]
    krylov = res["linear_iterations"]
    lines = re.findall(rf"PTC step +\d+ +dt = {_NUM} +Residual: {_NUM}",
                       res["out"])
    ke = re.findall(rf"kinetic-energy: {_NUM}", res["out"])
    check(len(lines) == steps and len(ke) == 1,
          f"{deck}: {len(lines)} PTC lines, {len(ke)} KE lines")
    resid, ke = float(lines[-1][1]), float(ke[0])
    print(f"  {steps} pseudo-steps (JAX CPU f64 {ref['ptc_steps']}, bound "
          f"+-1), {krylov} Krylov iterations (JAX {ref['krylov']}, bound "
          f"{PTC_KRYLOV_RTOL:.0%}), steady residual {resid:.4e}, "
          f"kinetic energy {ke:.6e} (JAX {ref['kinetic_energy']:.6e}, bound "
          f"{ENERGY_RTOL:g})")
    check(abs(steps - ref["ptc_steps"]) <= 1, f"{deck}: {steps} steps")
    check(_close(krylov, ref["krylov"], PTC_KRYLOV_RTOL),
          f"{deck}: {krylov} Krylov iterations against {ref['krylov']}")
    check(resid <= 1e-5 and res["solves_above_tolerance"] == 0,
          f"{deck}: steady residual {resid}")
    check(_close(ke, ref["kinetic_energy"], ENERGY_RTOL),
          f"{deck}: kinetic energy {ke}")
    return res


def _energies(out: str) -> list:
    return [(float(a), float(b)) for a, b in re.findall(
        rf"kinetic-energy: {_NUM}  enstrophy: {_NUM}", out)]


def _restart(torch, legs, whole: dict, dim: int, kernel: str,
             solver: str) -> list:
    """Run the two legs in one directory: the second restarts from the
    first's checkpoint.  Every step's KE and enstrophy within
    RESTART_RTOL of the uninterrupted run ``whole``; the two legs' Newton
    iterations equal its, their Krylov iterations within 1."""
    with tempfile.TemporaryDirectory() as tmp:
        runs = [drive_app(torch, dim, leg, kernel, solver=solver,
                          workdir=tmp) for leg in legs]
    got = _energies(runs[0]["out"]) + _energies(runs[1]["out"])
    want = _energies(whole["out"])
    check(len(got) == len(want), f"{legs}: {len(got)} steps, not "
          f"{len(want)}")
    for step, ((ke, en), (ke0, en0)) in enumerate(zip(got, want), start=1):
        leg = "b" if step > len(_energies(runs[0]["out"])) else "a"
        print(f"  step {step} (leg {leg}): KE {ke:.6e}, enstrophy {en:.6e}; "
              f"uninterrupted {ke0:.6e}, {en0:.6e}")
        check(_close(ke, ke0, RESTART_RTOL) and _close(en, en0, RESTART_RTOL),
              f"{legs[1]} step {step}: ({ke}, {en}) against ({ke0}, {en0})")
    newton = sum(r["newton_iterations"] for r in runs)
    krylov = sum(r["linear_iterations"] for r in runs)
    print(f"  Newton iterations {newton}, Krylov {krylov} over both legs "
          f"(uninterrupted {whole['newton_iterations']}, "
          f"{whole['linear_iterations']})")
    check(newton == whole["newton_iterations"]
          and abs(krylov - whole["linear_iterations"]) <= 1,
          f"{legs}: {newton} Newton, {krylov} Krylov iterations")
    return runs


def _schwarz(torch) -> tuple[dict, dict]:
    """Additive Schwarz on phases 4's and 5's decks: element matrices
    from the kernels' tangent probes."""
    out = []
    for deck, dim, kernel, nloc in (
            ("taylor_couette_r3_as.prm", 2, "gls_element", 27),
            ("tgv32_as.prm", 3, "gls_lattice", 32)):
        res = drive_app(torch, dim, deck, kernel)
        ref = JAX_REFERENCE[deck]
        got = _per_solve(deck, res["out"], len(ref["newton_per_solve"]))
        newton = [n for n, _ in got]
        per = res["linear_iterations"] / res["newton_iterations"]
        want = ref["krylov_per_newton"]
        tangents = sum(n for key, n in res["launches_by_shape"][kernel]
                       .items() if key[4] == "tangent")
        print(f"  {deck}: Newton per solve {newton} (JAX CPU f64 frozen "
              f"tau {ref['newton_per_solve']}), Krylov per Newton "
              f"iteration {per:.2f} (JAX CPU f32 {want:.2f}, bound "
              f"{AS_KRYLOV_RTOL:.0%}; f64 {ref['krylov_per_newton_f64']:.2f})"
              f"; {tangents} tangent launches, {nloc} per element-matrix "
              "build")
        check(newton == ref["newton_per_solve"], f"{deck}: Newton {newton}")
        check(_close(per, want, AS_KRYLOV_RTOL),
              f"{deck}: {per:.2f} Krylov iterations per Newton iteration")
        check(tangents >= nloc * res["newton_iterations"],
              f"{deck}: {tangents} tangent launches")
        _check_converged(deck, res)
        if dim == 2:
            _check_l2(deck, res["out"], ref)
        else:
            _check_energies(deck, res["out"], "tgv32_3steps.prm")
        out.append(res)
    return out[0], out[1]


# the element matrices on the card against the plain frozen-tau ones, the
# bound relative to the plain matrices' largest entry: (label, deck, dim)
EM_RTOL = 1e-6
EM_SHAPES = (("2D Q2 Taylor-Couette r3 (B1)", "taylor_couette_r3.prm", 2),
             ("3D Q1 TGV 32^3 (B2)", "tgv32_3steps.prm", 3),
             ("2D Q2 128^2 (B2)", "mms_q2_r7_sdirk3.prm", 2))


def _element_matrices(torch) -> dict:
    """The element matrices' columns from the kernel's tangent probes
    (nn*c launches) against the plain frozen-tau tangent's on the same
    rows, at the three shapes; times beside the whole build (the
    operator's ``element_matrices``: probes, reordering, constraints) and
    the node blocks.  Returns the worst max-abs error per kernel."""
    import dataclasses as dc

    from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
    from softx_2020_200_tpu_torch.ops.batched_kernel import tangent_batched
    from softx_2020_200_tpu_torch.ops.lattice_kernel import lattice_tangent
    from softx_2020_200_tpu_torch.solvers.base import GLSNavierStokesSolver
    from softx_2020_200_tpu_torch.solvers.gls import probe_columns
    worst = {"gls_element": 0.0, "gls_lattice": 0.0}
    for label, deck, dim in EM_SHAPES:
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(io.StringIO()):
            text = deck_text(deck).replace(
                "subsection simulation control\n",
                f"subsection simulation control\n  set output path = "
                f"{tmp}/\n", 1)
            solver = GLSNavierStokesSolver(
                SimulationParameters.from_text(text, dim=dim),
                device="cuda", dtype=torch.float32)
        op = solver.op
        x = _inputs(torch, op, seed=11)
        kern = op.kernel
        frozen = kern.plain(dc.replace(kern.stab, frozen_tau=True))
        a0 = sdt = 20.0
        if op.layout is None:
            ue = op._soa(x["u"])
            args = (op.xe_soa, op._soa(x["prev"]), op._fq_soa(x["fq"]), op.h)
            plain_tangent = tangent_batched
        else:
            ue = op._rows(x["u"])
            args = (op._rows(x["prev"]), op._fq_rows(x["fq"]))
            plain_tangent = lattice_tangent
        em = lambda: probe_columns(  # noqa: E731
            lambda due: kern.tangent(ue, due, *args, a0, sdt), ue)
        plain = lambda: probe_columns(  # noqa: E731
            lambda due: plain_tangent(frozen, ue, due, *args, a0, sdt), ue)
        build = lambda: op.element_matrices(  # noqa: E731
            x["u"], solver.bh.mask, x["prev"], x["fq"], a0, sdt)
        nb = lambda: kern.node_blocks(ue, *args, a0, sdt)  # noqa: E731
        got, want = em(), plain()
        err, rel = _rel(torch, got, want)
        name = "gls_element" if op.layout is None else "gls_lattice"
        worst[name] = max(worst[name], err)
        nloc, E = got.shape[0], got.shape[-1]
        del got, want
        # device time (a CUDA graph of the calls) and time with the host's
        # launches (events around single calls)
        dev, dev_nb = _graph_ms(torch, em, 5), _graph_ms(torch, nb, 5)
        ms, ms_nb = _median_ms(torch, em, 5), _median_ms(torch, nb, 5)
        ms_build = _median_ms(torch, build, 5)
        ms_plain = _median_ms(torch, plain, 3)
        print(f"  {label}: E {E}, {nloc} probe launches: max abs err "
              f"{err:.3e}, {rel:.3e} of scale (bound {EM_RTOL:g}); "
              f"probes {dev:.3f} ms device ({1e3 * dev / nloc:.2f} us per "
              f"probe), {ms:.3f} ms with the host's launches, plain "
              f"{ms_plain:.3f} ms; the whole build {ms_build:.3f} ms with "
              f"the host's launches; node blocks {dev_nb:.3f} ms device, {ms_nb:.3f} ms "
              f"with the host's launches")
        check(rel <= EM_RTOL, f"{label}: element matrices {rel}")
        del solver, op, kern, x
        torch.cuda.empty_cache()
    return worst


def phase_options(torch, earlier: dict) -> tuple[list, list, list, dict]:
    """Phase 11: the solver options of decks without a forest, at the
    decks' full size.  ``earlier`` holds phases 6's and 9's runs by deck
    (run here when missing), the uninterrupted runs the restarts are held
    to.  Returns the B1, B2 and B3 runs and the worst element-matrix
    max-abs error per kernel."""
    print("== phase 11: SDIRK2/3, pseudo-transient continuation, "
          "checkpoint/restart and additive Schwarz on the main path")
    b1, b2, b3 = [], [], []
    print(" -- SDIRK (B2): TGV 32^3 SDIRK2, MMS Q2 128^2 SDIRK3")
    b2 += _sdirk(torch)
    print(" -- SDIRK (B3): GD TGV 16^3 SDIRK2")
    b3.append(_gd_sdirk(torch))
    print(" -- pseudo-transient continuation (B2): cavity 256^2")
    b2.append(_ptc(torch))
    print(" -- checkpoint/restart (B2): TGV 32^3 GMG, 2 steps + 1")
    whole = earlier.get("tgv32_gmg.prm") or drive_app(
        torch, 3, "tgv32_gmg.prm", "gls_lattice")
    b2 += _restart(torch, ("tgv32_restart_a.prm", "tgv32_restart_b.prm"),
                   whole, 3, "gls_lattice", "gls")
    print(" -- checkpoint/restart (B3): GD TGV 16^3, 1 step + 1")
    whole = earlier.get("tgv16_gd.prm") or drive_app(
        torch, 3, "tgv16_gd.prm", "gd_lattice", solver="gd")
    b3 += _restart(torch, ("tgv16_gd_restart_a.prm",
                           "tgv16_gd_restart_b.prm"),
                   whole, 3, "gd_lattice", "gd")
    print(" -- additive Schwarz: TC r3 (B1), TGV 32^3 (B2)")
    tc, tgv = _schwarz(torch)
    b1.append(tc)
    b2.append(tgv)
    print(" -- element matrices from tangent probes against the plain "
          "frozen-tau version")
    worst = _element_matrices(torch)
    return b1, b2, b3, worst


# ----------------------------------------------------------------------
# phase 12: the decks with Kelly adaptation, on the forest
# ----------------------------------------------------------------------
_ADAPT = re.compile(r"^Mesh adaptation: (\d+) -> (\d+) cells, (\d+) dofs",
                    re.M)
# B1's shapes that phase 12's decks launched and phase 3b did not time:
# label -> (dim, degree, points per axis), filled by the pass after the
# runs (the forest changes E at every cycle and on every level)
FOREST_SHAPES: dict = {}


def _cells(deck: str, out: str, ref: dict) -> list:
    """The cells after each adaptation (the deck's "Mesh adaptation"
    lines), held to the JAX package's float32 run: the same number of
    adaptations, each within CELLS_RTOL (cells near the flagging
    threshold may trade places between float32 runs)."""
    got = [int(b) for _, b, _ in _ADAPT.findall(out)]
    want = ref["cells_f32"]
    print(f"  cells after each adaptation: {got}")
    print(f"  JAX CPU f32 (witness):        {want}")
    check(len(got) == len(want), f"{deck}: {len(got)} adaptations, not "
          f"{len(want)}")
    worst = max(abs(g - w) / w for g, w in zip(got, want))
    print(f"  largest difference {worst:.4%} (bound {CELLS_RTOL:.0%})")
    check(worst <= CELLS_RTOL, f"{deck}: cells {got} against {want}")
    return got


def _forces(out: str, bid: int) -> list:
    return [(float(a), float(b)) for a, b in re.findall(
        rf"^Force boundary {bid} : {_NUM} {_NUM}", out, re.M)]


def _cylinder(torch, states: dict) -> dict:
    """BASELINE #3 on the forest, 7 steps with Kelly after every step
    but the first (the BDF2 startup sub-steps adapt nothing, as in the
    JAX package): cells, Cd and Cl per step against the JAX package."""
    deck = "cylinder_kelly.prm"
    ref = JAX_REFERENCE[deck]
    res = drive_app(torch, 2, deck, "gls_element", b1_states=states)
    res["cells"] = _cells(deck, res["out"], ref)
    got = _forces(res["out"], 3)
    check(len(got) == len(ref["forces"]), f"{deck}: {len(got)} steps")
    # Cd = 2 F_x / (rho U^2 D), Cl likewise, with the mean inflow U = 1,
    # rho = 1 and the diameter D = 0.1
    for step, ((fx, fy), (rx, ry)) in enumerate(zip(got, ref["forces"]),
                                                start=1):
        err = max(abs(fx - rx), abs(fy - ry)) / max(abs(rx), abs(ry))
        print(f"  step {step:2d}: Cd {20 * fx: .6e} Cl {20 * fy: .6e}; JAX "
              f"CPU f64 Cd {20 * rx: .6e} Cl {20 * ry: .6e}; difference "
              f"{err:.2e} of |Cd|")
        check(err <= FORCE_KELLY_RTOL, f"{deck}: step {step}: force "
              f"({fx}, {fy}) against ({rx}, {ry})")
    # the impulsive start's solves sit at the f32 floor above the deck's
    # 1e-6, in the JAX package's f32 run too
    above, want = res["solves_above_tolerance"], \
        ref["solves_above_tolerance_f32"]
    print(f"  solves above tolerance: {above} of {res['newton_solves']} "
          f"(JAX CPU f32: {want}, the startup's)")
    check(above <= want, f"{deck}: {above} solves above tolerance")
    return res


def _cylinder_restart(torch, whole: dict, states: dict) -> list:
    """The cylinder deck in two legs (a checkpoint after the second
    step's adaptation, then a restart for steps 3-4), held to the first
    four steps of the uninterrupted run: forces per step within
    RESTART_RTOL, cells after each adaptation equal, Newton iterations per
    solve equal, Krylov within 1."""
    with tempfile.TemporaryDirectory() as tmp:
        runs = [drive_app(torch, 2, leg, "gls_element", workdir=tmp,
                          b1_states=states)
                for leg in ("cylinder_kelly_a.prm", "cylinder_kelly_b.prm")]
    out = runs[0]["out"] + runs[1]["out"]
    got, want = _forces(out, 3), _forces(whole["out"], 3)[:4]
    check(len(got) == 4, f"cylinder restart: {len(got)} steps")
    for step, (f, f0) in enumerate(zip(got, want), start=1):
        print(f"  step {step} (leg {'ab'[step > 2]}): force {f}; "
              f"uninterrupted {f0}")
        check(all(_close(a, b, RESTART_RTOL) for a, b in zip(f, f0)),
              f"cylinder restart step {step}: {f} against {f0}")
    cells = [int(b) for _, b, _ in _ADAPT.findall(out)]
    print(f"  cells {cells}; uninterrupted {whole['cells'][:3]}")
    check(cells == whole["cells"][:3], f"cylinder restart: cells {cells}")
    legs = _per_solve("cylinder restart", out)
    full = _per_solve("cylinder", whole["out"])[:len(legs)]
    print(f"  Newton and Krylov per solve {legs}; uninterrupted {full}")
    check(len(legs) == 5 and all(n == n0 and abs(k - k0) <= 1
                                 for (n, k), (n0, k0) in zip(legs, full)),
          f"cylinder restart: per solve {legs} against {full}")
    return runs


def _ghia_centerline(engine) -> list:
    """u_x of the engine's final solution at x = 0.5, y = GHIA_Y, from the
    nodes on that mesh line (a Q1 field is linear between them)."""
    import numpy as np
    nodes = engine.space.nodes
    u = engine.final.detach().cpu().double().numpy()
    on = np.abs(nodes[:, 0] - 0.5) < 1e-9
    order = np.argsort(nodes[on, 1])
    return list(np.interp(GHIA_Y, nodes[on, 1][order], u[on, 0][order]))


def _cavity(torch, states: dict) -> dict:
    """BASELINE #1 on the forest: 3 Kelly cycles; cells, Newton and Krylov
    per cycle (the JAX package's f32 run: Newton equal, Krylov within 1
    per Newton iteration), and the vertical centerline u at Ghia's
    stations against its f64 run."""
    deck = "cavity_kelly.prm"
    ref = JAX_REFERENCE[deck]
    engines = []
    res = drive_app(torch, 2, deck, "gls_element", engines=engines,
                    b1_states=states)
    _cells(deck, res["out"], ref)
    _check_newton_per_solve(deck, res)
    engine = engines[0]
    u = _ghia_centerline(engine)
    del engines[:], engine
    for y, g, w in zip(GHIA_Y, u, ref["centerline_u"]):
        print(f"  u(0.5, {y:.4f}) = {g: .6e} (JAX CPU f64 {w: .6e})")
    worst = max(abs(g - w) for g, w in zip(u, ref["centerline_u"]))
    print(f"  largest difference {worst:.3e} (bound {CENTERLINE_ATOL:g})")
    check(worst <= CENTERLINE_ATOL, f"{deck}: centerline off by {worst}")
    return res


def _tc_forest(torch, deck: str, states: dict) -> dict:
    """Taylor-Couette on the forest with forest GMG (the Q2 -> Q1
    p-level, then Q1 levels with 3 points per axis): converged, the
    FGMRES count of the JAX package's float32 run within FGMRES_RTOL,
    and its L2 errors against the JAX package's float64 ones."""
    ref = JAX_REFERENCE[deck]
    res = drive_app(torch, 2, deck, "gls_element", b1_states=states)
    _check_converged(deck, res)
    its = res["newton_iterations"]
    lin = res["linear_iterations"] / its
    want = ref["fgmres_per_newton_f32"]
    print(f"  Newton iterations {its} (JAX CPU f64 {ref['newton']}); FGMRES "
          f"per Newton iteration {lin:.2f} (JAX CPU f32 {want:.2f}, f64 "
          f"{ref['fgmres_per_newton']:.2f}; bound {FGMRES_RTOL:.0%})")
    check(its == ref["newton"], f"{deck}: {its} Newton iterations")
    check(abs(lin - want) <= FGMRES_RTOL * want, f"{deck}: {lin:.2f} "
          "FGMRES iterations per Newton iteration")
    _check_l2(deck, res["out"], ref)
    return res


def _gd_kelly(torch) -> dict:
    """The GD Kelly deck: plain torch on the forest (no B1, B2 or B3),
    with the velocity-block forest GMG; cells per adaptation, Newton
    iterations per solve and the final MMS L2 errors against the JAX
    package's float32 run (its cells may differ from the float64 run's,
    and then so do the errors)."""
    deck = "gd_kelly.prm"
    ref = JAX_REFERENCE[deck]
    engines = []
    res = drive_app(torch, 2, deck, None, solver="gd", engines=engines)
    _cells(deck, res["out"], ref)
    its, lin = res["newton_iterations"], res["linear_iterations"]
    print(f"  {res['newton_solves']} solves, {its} Newton and {lin} FGMRES "
          f"iterations (JAX CPU f32 {ref['newton']} and {ref['krylov_f32']}"
          f", f64 {ref['newton']} and {ref['krylov_f64']})")
    check(abs(its - ref["newton"]) <= res["newton_solves"],
          f"{deck}: {its} Newton iterations")
    _check_converged(deck, res)
    engine = engines.pop()
    got = [float(e) for e in engine.l2_errors(engine.final,
                                               engine.control.time)]
    del engine
    for what, g, w, w64 in zip(("velocity", "pressure"), got,
                               ref["l2_f32"], ref["l2_f64"]):
        print(f"  final L2 error {what} {g:.8e} (JAX CPU f32 {w:.8e}, f64 "
              f"{w64:.8e}; bound {GD_L2_RTOL:g} of f32)")
        check(_close(g, w, GD_L2_RTOL), f"{deck}: L2 error {what} {g}")
    return res


def _sphere(torch, states: dict) -> dict:
    """BASELINE #5 at its base mesh, one Kelly cycle: B1 in 3D Q1 on a
    forest with hanging faces; cells, Newton and Krylov iterations per
    solve (the JAX package's f32 run with tau frozen: Newton equal, Krylov
    within 1 per Newton iteration) and the force on the sphere against
    its f64 run."""
    deck = "sphere_kelly.prm"
    ref = JAX_REFERENCE[deck]
    res = drive_app(torch, 3, deck, "gls_element", b1_states=states)
    _cells(deck, res["out"], ref)
    _check_newton_per_solve(deck, res)
    f = [float(x) for x in re.findall(
        rf"^Force boundary 3 : {_NUM} {_NUM} {_NUM}", res["out"], re.M)[-1]]
    want = ref["force_sphere"]
    err = max(abs(a - b) for a, b in zip(f, want)) / max(map(abs, want))
    print(f"  force on the sphere {f} (JAX CPU f64 {want}), difference "
          f"{err:.2e} of its largest component (bound {FORCE_KELLY_RTOL:g})")
    check(err <= FORCE_KELLY_RTOL, f"{deck}: force {f}")
    return res


def _recorded_shapes(torch, states: dict, times: dict, kind: str,
                     registry: dict) -> float:
    """The pass after phase 12's (``kind`` "forest") or phase 13's
    ("shard") runs: at every (dim, degree, points per axis, E) at which
    B1 launched and that no earlier pass timed, B1's primal, tangent and
    node blocks on the recorded operator's own geometry and state (and a
    seeded direction), against the plain version, then timed beside it;
    each shape's label goes to ``registry``.  Returns the worst max-abs
    error."""
    import dataclasses
    from softx_2020_200_tpu_torch.ops import batched_kernel as bk
    timed = {(*_shape_keys("gls_element")[label], row["E"])
             for label, row in times.items()}
    worst = 0.0
    todo = sorted(k for k in states if k not in timed)
    print(f" -- B1 at the {len(todo)} {kind} shapes these decks launched "
          f"that no earlier pass timed (kernel, and plain version, ms)")
    for key in todo:
        dim, degree, q1d, E = key
        k, ue, args = states.pop(key)
        g = torch.Generator(ue.device).manual_seed(12)
        due = torch.randn(ue.shape, device=ue.device, dtype=ue.dtype,
                          generator=g)
        full = k.plain()
        frozen = k.plain(dataclasses.replace(k.stab, frozen_tau=True))
        kernel = {"primal": lambda: k.residual(ue, *args),
                  "tangent": lambda: k.tangent(ue, due, *args),
                  "node blocks": lambda: k.node_blocks(ue, *args)}
        plain = {"primal": lambda: full(ue, *args),
                 "tangent": lambda: bk.tangent_batched(frozen, ue, due,
                                                       *args),
                 "node blocks": lambda: bk.node_blocks_batched(frozen, ue,
                                                               *args)}
        label = f"{kind} {dim}D Q{degree} q{q1d} E={E}"
        registry[label] = (dim, degree, q1d)
        worst = max(worst, _check_outputs(torch, label, E, kernel,
                                          _outputs(torch, plain)))
        _time_variants(torch, label, E, kernel, plain, times)
        del k, ue, args, due, kernel, plain
        torch.cuda.empty_cache()
    return worst


def phase_forest(torch, times_b1: dict) -> tuple[list, float]:
    """Phase 12: the Kelly decks on the forest, through the apps, then B1
    at every shape they launched.  Returns the B1 runs and the worst
    max-abs error of the per-shape pass."""
    print("== phase 12: Kelly adaptation on the forest (cylinder, cavity, "
          "Taylor-Couette with forest GMG, restart, GD, 3D sphere)")
    states, b1 = {}, []
    print(" -- cylinder Re 100 (BASELINE #3), 7 steps, Kelly every step")
    cyl = _cylinder(torch, states)
    b1.append(cyl)
    print(" -- the cylinder deck restarted on its forest after step 2")
    b1 += _cylinder_restart(torch, cyl, states)
    print(" -- lid-driven cavity Re 400 (BASELINE #1), 3 Kelly cycles")
    b1.append(_cavity(torch, states))
    print(" -- Taylor-Couette r3 on the forest, forest GMG")
    b1.append(_tc_forest(torch, "tc_forest_r3.prm", states))
    print(" -- GD with Kelly (plain torch, velocity-block forest GMG)")
    _gd_kelly(torch)
    print(" -- 3D sphere (BASELINE #5) at its base mesh, one Kelly cycle")
    b1.append(_sphere(torch, states))
    worst = _recorded_shapes(torch, states, times_b1, "forest",
                             FOREST_SHAPES)
    return b1, worst


# ----------------------------------------------------------------------
# phase 13: the multi-device path on one card
# ----------------------------------------------------------------------
# Shards per run: the apps' ``devices=[cuda:0] * SHARDS``, every exchange,
# reduction and per-shard B1 launch on the one card this script needs
# (multi-card speed is not measured here)
SHARDS = 4
# B1's shapes that phase 13's runs launched and earlier passes did not
# time: label -> (dim, degree, points per axis), filled by its pass
SHARD_SHAPES: dict = {}
# phase 13's float32 4-shard runs: the MMS L2 per step against the JAX
# package's f64 values, relative, and twice that against phase 7's
# float32 run; the cylinder's Cd and Cl per step against the JAX
# package's 4-way f64 forces, over |Cd| (Cd = 20 F_x, Cl = 20 F_y), and
# twice that against its 4-way float32 run (each float32 run carries its
# own error against f64: phase 7's 1.3e-3 at step 3, phase 12's up to
# 3.0e-5 of |Cd|, the JAX 4-way f32 run's 3.0e-5 at step 3); the MMS
# FGMRES count against the JAX package's 4-way run, relative
SHARD_L2_RTOL = 1e-3
SHARD_FORCE_RTOL = 3e-5
SHARD_FGMRES_RTOL = 0.05
# the GD deck's final L2 velocity error (3.2100e-5 in the JAX package's
# f64 golden, tests/golden/gd_mms_bdf2.output) over 4 shards against 1
# shard and against the golden,
# relative.  Newton stops at 1e-5 in float32 (at 1e-6 a float32 solve on
# the CPU grinds through 23 Newton and 15,796 FGMRES iterations), and
# the iterate it stops at moves this small error by up to 0.8 % between
# runs (an H100: 4 shards 3.2351e-5, 1 shard 3.2143e-5; the CPU in
# float32: 3.2216e-5 and 3.1855e-5)
SHARD_GD_L2_RTOL = 1e-2
GD_MMS_L2_F64 = 3.2100e-05
# the same deck through the JAX package's GD app in float32 on the CPU
# (test mode on to print the L2 per step, Newton 1e-5), 4-way on 4
# virtual devices and on one: its own shard counts are 8.8 % apart, 10.8
# % and 2.2 % off the f64 golden (printed beside the card's, not held)
GD_MMS_L2_JAX_F32 = {4: 2.86246086e-05, 1: 3.13848213e-05}
DECKS.update({
    # the golden GD MMS deck (Q2-Q1, BDF2 with its startup sub-step, 3
    # steps) at its own refinement 2 (4^2 cells), Newton to 1e-5 (C4),
    # outside test mode: over shards it takes the JAX sharded path's
    # block-Schur preconditioner (velocity node blocks, no multigrid),
    # whose FGMRES counts grow with the mesh: at refinement 3 it took
    # 4,653 iterations and 155 s over 4 shards on an H100
    "gd_mms_r2.prm": ("tests/golden/gd_mms_bdf2.prm", [
        ("tolerance", "1e-5"),
        ("text", ("subsection test\n  set enable = true",
                  "subsection test\n  set enable = false"))]),
})
# the golden restart decks (tests/golden/restart_adaptive_{a,b}.prm: MMS,
# Q1, BDF2, a checkpoint every 2 steps; leg a ends at t = 0.2, leg b
# restarts and runs on to t = 0.35) at refinement 7 (128^2 cells, 'auto'
# -> GMG on 4 levels), with its residuals printed, a fixed dt of 0.05
# (with the decks' CFL-adaptive dt leg a's last step is clipped to end at
# 0.2, and no uninterrupted run takes the steps the two legs take) and
# Newton to 1e-4: a shard count sums in its own order, and a solve that
# ends near the float32 floor can take another Newton iteration over
# other shards (on the CPU in float32 at 32^2 with 1e-5, the last solve
# of a 2-shard restart took 9 iterations where 4 shards took 2); and the
# same run uninterrupted
_RESTART_R7 = [("initial refinement", "7"), ("adapt", "false"),
               ("text", ("set verbosity      = quiet\n  set tolerance      "
                         "= 1e-10", "set verbosity      = verbose\n  set "
                         "tolerance      = 1e-4"))]
DECKS.update({
    "restart_r7_a.prm": ("tests/golden/restart_adaptive_a.prm", _RESTART_R7),
    "restart_r7_b.prm": ("tests/golden/restart_adaptive_b.prm", _RESTART_R7),
    "restart_r7.prm": ("tests/golden/restart_adaptive_b.prm", _RESTART_R7 + [
        ("checkpoint", "false"), ("restart", "false")]),
})


def _print_shards(res: dict, one: dict | None, label: str) -> None:
    """The shards of a run (owned and ghost nodes per shard, bytes per
    refresh; the first and the last sharded solver of the run), its
    seconds per Newton iteration and kernel launches beside the 1-shard
    run ``one`` (not held: one card runs every shard)."""
    reports = res["shards"]
    check(reports, f"{res['deck']}: no sharded solver was built")
    for what, (rows, nbytes) in (("first", reports[0]),
                                 ("last", reports[-1]))[:len(reports)]:
        print(f"  shards ({what} of {len(reports)} layouts): owned/ghost "
              f"nodes {rows}; {nbytes:,} bytes per refresh")
    if one is not None:
        print(f"  {res['s_per_newton']:.4f} s per Newton iteration "
              f"({len(rows)} shards on one card) against {label}'s "
              f"{one['s_per_newton']:.4f}; kernel launches "
              f"{res['launches']} against {one['launches']}")


def _sharded_mms(torch, devices, one: dict, states: dict) -> dict:
    """Phase 7's deck over the shards: converged, Newton equal to the JAX
    package's 4-way run (f64: its f32 run stalls, JAX_REFERENCE), FGMRES
    within SHARD_FGMRES_RTOL of it, the L2 errors per step within
    SHARD_L2_RTOL of the JAX package's f64 values (phase 7's witness) and
    within twice that of phase 7's float32 run, which is itself up to
    1.3e-3 off the f64 value at step 3, where the error is smallest."""
    deck = "mms_q2_r8.prm"
    ref = JAX_REFERENCE[deck]
    res = drive_app(torch, 2, deck, "gls_element", b1_states=states,
                    devices=devices)
    _print_shards(res, one, "phase 7")
    _check_converged(deck, res)
    its, lin = res["newton_iterations"], res["linear_iterations"]
    print(f"  Newton {its} (JAX CPU 4-way {ref['newton_4way']}), FGMRES "
          f"{lin} (JAX {ref['fgmres_4way']}; bound {SHARD_FGMRES_RTOL:.0%})")
    check(its == ref["newton_4way"], f"{deck}: {its} Newton iterations")
    check(_close(lin, ref["fgmres_4way"], SHARD_FGMRES_RTOL),
          f"{deck}: {lin} FGMRES iterations")
    pat = rf"L2 error velocity : {_NUM}\n"
    got = [float(x) for x in re.findall(pat, res["out"])]
    one_l2 = [float(x) for x in re.findall(pat, one["out"])]
    want = ref["l2_velocity"]
    check(len(got) == len(one_l2) == len(want), f"{deck}: {len(got)} L2 "
          "lines")
    for step, (g, w, o) in enumerate(zip(got, want, one_l2), start=1):
        print(f"  step {step}: L2 error velocity {g:.8e} ({SHARDS} shards), "
              f"JAX CPU f64 {w:.8e}, rel diff {abs(g - w) / w:.3e} (bound "
              f"{SHARD_L2_RTOL:g}); phase 7 {o:.8e}, rel diff "
              f"{abs(g - o) / o:.3e} (bound {2 * SHARD_L2_RTOL:g})")
        check(_close(g, w, SHARD_L2_RTOL), f"{deck} step {step}: L2 {g}")
        check(_close(g, o, 2 * SHARD_L2_RTOL),
              f"{deck} step {step}: L2 {g} against phase 7's {o}")
    return res


def _sharded_cylinder(torch, devices, one: dict, states: dict) -> dict:
    """Phase 12's cylinder over the shards (the forest re-sharded after
    every adaptation, the BDF2 startup step's included, as in the JAX
    package's sharded loop): the JAX package's 4-way cells at every
    adaptation, Cd and Cl per step within SHARD_FORCE_RTOL of |Cd| of
    its 4-way f64 forces and within twice that of its 4-way f32 forces
    (each float32 run carries its own error against f64; the JAX 4-way
    f32 run's is up to 3.0e-5 of |Cd|).  Phase 12's 1-device run adapts
    once less and is printed beside it only for its seconds."""
    deck = "cylinder_kelly.prm"
    ref = JAX_REFERENCE[deck]
    res = drive_app(torch, 2, deck, "gls_element", b1_states=states,
                    devices=devices)
    _print_shards(res, one, "phase 12")
    cells = [int(b) for _, b, _ in _ADAPT.findall(res["out"])]
    print(f"  cells after each adaptation {cells} (JAX CPU 4-way f32 "
          f"{ref['cells_4way_f32']}; phase 12, 1 device, from step 2 on: "
          f"{one['cells']})")
    check(cells == ref["cells_4way_f32"], f"{deck}: cells {cells}")
    res["cells"] = cells
    got = _forces(res["out"], 3)
    check(len(got) == len(ref["forces_4way"]), f"{deck}: {len(got)} steps")
    for step, ((fx, fy), (rx, ry), (ox, oy)) in enumerate(
            zip(got, ref["forces_4way"], ref["forces_4way_f32"]), start=1):
        err = max(abs(fx - rx), abs(fy - ry)) / abs(rx)
        err32 = max(abs(fx - ox), abs(fy - oy)) / abs(ox)
        print(f"  step {step}: Cd {20 * fx: .6e} Cl {20 * fy: .6e}; JAX CPU "
              f"4-way f64 Cd {20 * rx: .6e} Cl {20 * ry: .6e}, difference "
              f"{err:.2e} of |Cd| (bound {SHARD_FORCE_RTOL:g}); 4-way f32 "
              f"Cd {20 * ox: .6e} Cl {20 * oy: .6e}, difference {err32:.2e} "
              f"(bound {2 * SHARD_FORCE_RTOL:g})")
        check(err <= SHARD_FORCE_RTOL, f"{deck}: step {step}: force "
              f"({fx}, {fy}) against ({rx}, {ry})")
        check(err32 <= 2 * SHARD_FORCE_RTOL, f"{deck}: step {step}: force "
              f"({fx}, {fy}) against the f32 run's ({ox}, {oy})")
    above = res["solves_above_tolerance"]
    print(f"  solves above tolerance: {above} of {res['newton_solves']} "
          f"(JAX CPU 4-way f32: {ref['solves_above_tolerance_4way_f32']}, "
          f"the startup's)")
    check(above <= ref["solves_above_tolerance_4way_f32"],
          f"{deck}: {above} solves above tolerance")
    return res


def _leg_files(tmp: str, n: int) -> None:
    """Leg a's checkpoint in ``tmp``: one file per shard (n of them) and
    a manifest without fields."""
    import glob
    import numpy as np
    found = sorted(glob.glob(os.path.join(tmp, "**", "*.shard*.npz"),
                             recursive=True))
    check(found, "restart: leg a wrote no shard files")
    base = found[0].rsplit(".shard", 1)[0]
    files = [os.path.basename(f) for f in found]
    with np.load(base + ".npz") as man:
        fields = sorted(set(man.files) & {"u", "previous"})
    print(f"  leg a wrote {files} and a manifest with fields {fields}")
    name = os.path.basename(base)
    check(files == [f"{name}.shard{p}.npz" for p in range(n)],
          f"restart: shard files {files}")
    check(not fields, "restart: the manifest holds fields")


# what a run prints per step: the step with its time and dt, the L2
# error, each solve's Newton and Krylov counts (not the Newton residuals:
# at the float32 floor their last printed digits are noise)
_STEP = re.compile(r"^\*\*\* Time step.*$", re.M)
_L2_LINE = re.compile(rf"^L2 error velocity : {_NUM}$", re.M)


def _sharded_restart_mms(torch, dev, states: dict) -> list:
    """The golden restart decks at refinement 7 across shard counts: leg
    a over 4 shards (a checkpoint every 2 steps: the engine's manifest
    and one file per shard), leg b restarted over 2 shards.  Held to the
    uninterrupted 4-shard run: leg a equal in every printed step, time,
    dt, L2 digit and count (the same shards); leg b's steps, times and
    dts equal as printed, its L2 errors within SHARD_L2_RTOL, each
    solve's Newton iterations equal and Krylov iterations within 1
    (float32 sums in another order over 2 shards)."""
    whole = drive_app(torch, 2, "restart_r7.prm", "gls_element",
                      b1_states=states, devices=[dev] * 4)
    with tempfile.TemporaryDirectory() as tmp:
        a = drive_app(torch, 2, "restart_r7_a.prm", "gls_element",
                      workdir=tmp, b1_states=states, devices=[dev] * 4)
        _leg_files(tmp, 4)
        b = drive_app(torch, 2, "restart_r7_b.prm", "gls_element",
                      workdir=tmp, b1_states=states, devices=[dev] * 2)
    for run in (whole, a, b):
        _print_shards(run, None, "")
    steps = _STEP.findall(whole["out"])
    na = len(_STEP.findall(a["out"]))
    l2 = [float(x) for x in _L2_LINE.findall(whole["out"])]
    solves = _per_solve("restart", whole["out"])
    n_solves_a = len(_per_solve("leg a", a["out"]))
    print(f"  leg a {na} steps, leg b {len(_STEP.findall(b['out']))}, "
          f"uninterrupted {len(steps)}")
    check(_STEP.findall(a["out"]) == steps[:na]
          and [float(x) for x in _L2_LINE.findall(a["out"])] == l2[:na]
          and _per_solve("leg a", a["out"]) == solves[:n_solves_a],
          "restart: leg a differs from the uninterrupted run")
    got_steps = _STEP.findall(b["out"])
    check(got_steps == steps[na:], f"restart: leg b's steps {got_steps}")
    for line, g, w in zip(got_steps, _L2_LINE.findall(b["out"]), l2[na:]):
        g = float(g)
        print(f"  {line}: L2 error velocity {g:.4e} (leg b, 2 shards), "
              f"{w:.4e} (uninterrupted, 4 shards)")
        check(_close(g, w, SHARD_L2_RTOL), f"restart: {line}: L2 {g}")
    legs = _per_solve("leg b", b["out"])
    full = solves[n_solves_a:]
    print(f"  leg b Newton and Krylov per solve {legs}; uninterrupted "
          f"{full}")
    check(len(legs) == len(full) and all(
        n == n0 and abs(k - k0) <= 1 for (n, k), (n0, k0) in zip(legs, full)),
        f"restart: leg b per solve {legs} against {full}")
    return [whole, a, b]


def _sharded_restart(torch, dev, whole: dict, states: dict) -> list:
    """The cylinder in two legs across shard counts: leg a over 4 shards
    writes the engine's manifest (forest, control; no fields) and one
    file per shard after step 2's adaptation (it adapts after steps 1
    and 2, as the uninterrupted run does); leg b restarts over 2
    shards for steps 3-4.  Held to the uninterrupted 4-shard run: leg a
    equal in every printed force digit (the same shards); the cells and
    each solve's Newton iterations equal, its Krylov iterations within 1,
    and the forces per step within SHARD_FORCE_RTOL of |F_x| (float32
    sums in another order over 2 shards: the lift's 4th digit and a
    Krylov iteration moved in a debug run)."""
    with tempfile.TemporaryDirectory() as tmp:
        a = drive_app(torch, 2, "cylinder_kelly_a.prm", "gls_element",
                      workdir=tmp, b1_states=states, devices=[dev] * 4)
        _leg_files(tmp, 4)
        b = drive_app(torch, 2, "cylinder_kelly_b.prm", "gls_element",
                      workdir=tmp, b1_states=states, devices=[dev] * 2)
    for leg in (a, b):
        _print_shards(leg, None, "")
    out = a["out"] + b["out"]
    lines = re.findall(r"^Force boundary 3 : .*$", whole["out"], re.M)
    check(re.findall(r"^Force boundary 3 : .*$", a["out"], re.M)
          == lines[:2], "cylinder restart: leg a's forces differ")
    got, want = _forces(out, 3), _forces(whole["out"], 3)[:4]
    check(len(got) == 4, f"cylinder restart: {len(got)} steps")
    for step, ((fx, fy), (wx, wy)) in enumerate(zip(got, want), start=1):
        err = max(abs(fx - wx), abs(fy - wy)) / abs(wx)
        print(f"  step {step} (leg {'ab'[step > 2]}): force ({fx}, {fy}); "
              f"uninterrupted ({wx}, {wy}); difference {err:.2e} of |F_x| "
              f"(bound {SHARD_FORCE_RTOL:g})")
        check(err <= SHARD_FORCE_RTOL, f"cylinder restart step {step}")
    cells = [int(c) for _, c, _ in _ADAPT.findall(out)]
    check(cells == whole["cells"][:4], f"cylinder restart: cells {cells}")
    legs = _per_solve("cylinder restart", out)
    full = _per_solve("cylinder", whole["out"])[:len(legs)]
    print(f"  cells {cells}; Newton and Krylov per solve {legs}; "
          f"uninterrupted {full}")
    check(len(legs) == 5 and all(n == n0 and abs(k - k0) <= 1
                                 for (n, k), (n0, k0) in zip(legs, full)),
          f"cylinder restart across shard counts: per solve {legs}")
    return [a, b]


def _sharded_gd(torch, dev) -> dict:
    """The GD MMS deck over 4 shards against 1 shard (plain torch, the
    block-Schur preconditioner): both converged, the final velocity L2
    error within SHARD_GD_L2_RTOL of each other and of the f64 golden;
    the final velocity fields' largest difference is printed (the
    enclosed flow's pressure is fixed up to a constant)."""
    deck = "gd_mms_r2.prm"
    l2, final, runs = {}, {}, {}
    for n in (1, SHARDS):
        engines = []
        runs[n] = drive_app(torch, 2, deck, None, solver="gd",
                            engines=engines, devices=[dev] * n)
        _check_converged(deck, runs[n])
        engine = engines.pop()
        l2[n] = [float(e) for e in engine.l2_errors(engine.final,
                                                    engine.control.time)]
        final[n] = engine.final[:engine.op.Nv * engine.dim]
        del engine
    _print_shards(runs[SHARDS], runs[1], "the 1-shard run")
    diff = float((final[SHARDS] - final[1]).abs().max()
                 / final[1].abs().max())
    print(f"  final velocity: largest difference {diff:.3e} of the "
          f"largest value")
    for what, g, w in zip(("velocity", "pressure"), l2[SHARDS], l2[1]):
        print(f"  final L2 error {what} {g:.8e} ({SHARDS} shards), {w:.8e} "
              f"(1 shard), rel diff {abs(g - w) / w:.3e}")
    g, w = l2[SHARDS][0], l2[1][0]
    print(f"  velocity against the f64 golden {GD_MMS_L2_F64:.4e}: rel diff "
          f"{abs(g - GD_MMS_L2_F64) / GD_MMS_L2_F64:.3e} ({SHARDS} shards), "
          f"{abs(w - GD_MMS_L2_F64) / GD_MMS_L2_F64:.3e} (1 shard); bound "
          f"{SHARD_GD_L2_RTOL:g}")
    print(f"  the JAX package's f32 run on the CPU: "
          f"{GD_MMS_L2_JAX_F32[SHARDS]:.8e} ({SHARDS}-way), "
          f"{GD_MMS_L2_JAX_F32[1]:.8e} (1 device)")
    check(_close(g, w, SHARD_GD_L2_RTOL) and all(
        _close(x, GD_MMS_L2_F64, SHARD_GD_L2_RTOL) for x in (g, w)),
        f"{deck}: final L2 error velocity {g} ({SHARDS} shards), {w}")
    return runs[SHARDS]


def phase_sharded(torch, times_b1: dict, earlier: dict) -> tuple[list,
                                                                 float]:
    """Phase 13: the apps over SHARDS shards on cuda:0, then B1 at every
    shard shape they launched.  ``earlier`` holds phases 7's and 12's
    1-device runs by deck.  Returns the B1 runs and the worst max-abs
    error of the per-shape pass."""
    print(f"== phase 13: the multi-device path, {SHARDS} shards on cuda:0 "
          f"(B1 per shard, coarse levels whole)")
    dev = torch.device("cuda", 0)
    states = {}
    print(" -- MMS Q2 256^2 (phase 7's deck)")
    mms = _sharded_mms(torch, [dev] * SHARDS, earlier["mms_q2_r8.prm"],
                       states)
    print(" -- the cylinder with Kelly (phase 12's deck, 7 steps)")
    cyl = _sharded_cylinder(torch, [dev] * SHARDS,
                            earlier["cylinder_kelly.prm"], states)
    print(" -- the cylinder restarted across shard counts (4 -> 2)")
    legs = _sharded_restart(torch, dev, cyl, states)
    print(" -- the golden restart decks at 128^2 across shard counts "
          "(4 -> 2)")
    legs += _sharded_restart_mms(torch, dev, states)
    print(" -- GD MMS at refinement 2 (plain torch), 4 shards and 1")
    _sharded_gd(torch, dev)
    worst = _recorded_shapes(torch, states, times_b1, "shard",
                             SHARD_SHAPES)
    return [mms, cyl] + legs, worst


# ----------------------------------------------------------------------
# phase 14: the bf16 operand build
# ----------------------------------------------------------------------
# a bf16-operand instance against its plain version on the same bf16
# operands: both round one float32 value per output to bf16, and the two
# values differ only by the order of their float32 sums: two bf16 ulps
# (2 x 2^-8) of the output's scale
BF16OP_RTOL = 8e-3
# a bf16 operator against the float32 operator on the same inputs: the
# JAX package's bound for its all-bf16 build
# (tests/test_pallas_lattice.py::test_lattice_all_bf16_build)
BF16_OPERATOR_RTOL = 3e-2
# (a) B1 on non-affine meshes (dim, degree, points per axis, cells): E % 4
# != 0 (195 and 210 elements: 4-byte loads) and below one tile (9, 12),
# each shape of SUPPORTED, and Q1 with 3 points per axis (STAGED only)
B1_BF16OP = tuple(
    (d, k, None, c) for d, k in ((2, 1), (2, 2), (3, 1), (3, 2))
    for c in (((15, 13), (3, 3)) if d == 2 else ((7, 6, 5), (2, 2, 3)))
) + ((2, 1, 3, (15, 13)), (3, 1, 3, (7, 6, 5)))
# (a) B2 on box lattices: the same sizes, every compiled shape
B2_BF16OP = tuple(entry for entry in B2_PARITY
                  if entry[3] not in ((12, 9), (5, 4, 3)))
# (a) B3: bounded and periodic with E % 4 != 0, 3D, below one tile
B3_BF16OP = ((2, (15, 13), False), (2, (15, 13), True),
             (3, (7, 6, 5), False), (2, (3, 3), False),
             (3, (2, 2, 3), False))
# (b) the full-width shapes, as phases 3b-3d label them: (kernel, label,
# what the operators are built on)
BF16OP_SHAPES = (
    ("gls_lattice", "3D Q1 TGV 32^3", ("lattice", 3, 1, (32,) * 3, True)),
    ("gls_lattice", "3D Q1 box 64^3", ("lattice", 3, 1, (64,) * 3, False)),
    ("gls_element", "2D Q2 Taylor-Couette r5", ("space", 2, 2, 5)),
    ("gls_element", "3D Q1 32^3 (moved)", ("space", 3, 1, 32)),
    ("gd_lattice", "2D Q2-Q1 256^2 (GD cavity)", ("gd", 2, (256,) * 2,
                                                  False)),
    ("gd_lattice", "3D Q2-Q1 16^3 (GD TGV)", ("gd", 3, (16,) * 3, True)))


def _gls_ops(torch, space, device, lsic=False, n_q1d=None, builds=("f32",
                                                                  "bf16")):
    """GLS operators on one space with frozen-tau flags: "f32", "state"
    (float32 with a bf16 Jacobian state) and "bf16" (bf16 operands)."""
    from softx_2020_200_tpu_torch.solvers.gls import GLSOperator, StabFlags
    kw = dict(nu=0.01, n_q1d=n_q1d, device=device,
              stab=StabFlags(lsic=lsic, frozen_tau=True))
    dtypes = {"f32": dict(dtype=torch.float32),
              "state": dict(dtype=torch.float32,
                            state_dtype=torch.bfloat16),
              "bf16": dict(dtype=torch.bfloat16)}
    return {b: GLSOperator(space, **kw, **dtypes[b]) for b in builds}


def _bf16op_calls(torch, op, x, skewed: bool = False):
    """(kernel calls, plain calls, forced) of a bf16 GLS operator's kernel
    (B1 or B2) on its rows of the bf16 inputs ``x`` (``_inputs``): the
    primal, the frozen-tau tangent and the node blocks of the bf16-operand
    instances, in the operator's rows (``narrow_rows``: TMA where the
    pointers allow it) or, ``skewed``, every row at a pitch that takes the
    4-byte cp.async path.  The plain calls are the module's plain version
    (widen, the float32 plain kernel, round) on the same rows."""
    k = op.kernel
    if op.layout is None:
        ue, due = op._soa(x["u"]), op._soa(x["v"])
        state = [op.xe_state, op._soa(x["prev"]), op._fq_soa(x["fq"]),
                 op.h_state]
    else:
        ue, due = op._rows(x["u"]), op._rows(x["v"])
        state = [op._rows(x["prev"]), op._fq_rows(x["fq"])]
    if skewed:
        ue, due = _skewed_rows(torch, ue), _skewed_rows(torch, due)
        state = [_skewed_rows(torch, t) for t in state]
    args = (*state, 1.5, 20.0)
    kernel = {"primal bf16op": lambda: k.residual(ue, *args),
              "tangent bf16op": lambda: k.tangent(ue, due, *args),
              "node blocks bf16op": lambda: k.node_blocks(ue, *args)}
    plain = {"primal bf16op": lambda: k.plain_residual(ue, *args),
             "tangent bf16op": lambda: k.plain_tangent(ue, due, *args),
             "node blocks bf16op": lambda: k.plain_node_blocks(ue, *args)}

    def forced(route, split=None):
        kw = {} if split is None else {"split": split}
        return {what: (lambda m=m, d=d: k._call(m, ue, d, args, route, **kw))
                for what, m, d in (("primal bf16op", 0, None),
                                   ("tangent bf16op", 1, due),
                                   ("node blocks bf16op", 2, None))}

    return kernel, plain, forced


def _gd_operator(torch, dim, cells, periodic, device, dtype, shear=0.0):
    """A GD operator on a box lattice (x sheared by ``shear`` y)."""
    from softx_2020_200_tpu_torch.fem import mesh as M
    from softx_2020_200_tpu_torch.solvers.gd import GDOperator
    m = M.subdivided_hyper_rectangle([0.0] * dim, [1.0, 0.7, 1.3][:dim],
                                     list(cells), True, dim=dim)
    m.vertices[:, 0] += shear * m.vertices[:, 1]
    if periodic:
        m.periodic += [(2 * a, 2 * a + 1, a) for a in range(dim)]
    return GDOperator(m, nu=0.01, gamma=0.8, dtype=dtype, device=device)


def _gd_inputs(torch, op, seed: int):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, s=1.0):
        return (s * torch.randn(*shape, generator=g, dtype=torch.float64)
                ).to(op.device, op.dtype)

    return dict(x=rnd(op.n_dofs, s=0.3), dx=rnd(op.n_dofs),
                vprev=rnd(op.Nv, op.dim, s=0.2),
                fq=rnd(op.space_v.n_elements, op.n_q, op.dim, s=0.1))


def _gd_bf16op_calls(torch, op, x, skewed: bool = False):
    """(kernel calls, plain calls, forced) of B3's bf16-operand instances
    on a bf16 GD operator's rows of ``x`` (``_gd_inputs``), as
    ``_bf16op_calls``."""
    k, a0 = op.kernel, 1.5
    ue, due = op._rows(x["x"]), op._rows(x["dx"])
    vpe, fq = op._vrows(x["vprev"]), op._fq_rows(x["fq"])
    if skewed:
        ue, due, vpe, fq = (_skewed_rows(torch, t) for t in (ue, due, vpe, fq))
    kernel = {"primal bf16op": lambda: k.residual(ue, vpe, fq, a0),
              "tangent bf16op": lambda: k.tangent(ue, due, a0)}
    plain = {"primal bf16op": lambda: k.plain_residual(ue, vpe, fq, a0),
             "tangent bf16op": lambda: k.plain_tangent(ue, due, a0)}

    def forced(route, split=None):
        return {"primal bf16op": lambda: k._call(0, ue, None, vpe, fq, a0,
                                                 route),
                "tangent bf16op": lambda: k._call(1, ue, due, None, None,
                                                  a0, route)}

    return kernel, plain, forced


def _check_bf16op(torch, label, E, calls, has_registers, dim=None):
    """(worst max-abs error, worst relative error) of the bf16-operand
    instances against their plain version (computed once, on the rows of
    the default layout), on every route, in both row layouts."""
    err, rels, want = 0.0, [], None
    for skewed in (False, True):
        kernel, plain, forced = calls(skewed)
        want = want or _outputs(torch, plain)
        err = max(err, _check_settings(
            torch, f"{label}{' skewed' if skewed else ''}", E, kernel, forced,
            want, has_registers, dim, BF16OP_RTOL, rels))
    return err, max(rels)


def _worse(a, b):
    """The larger max-abs error and the larger relative one of two
    (abs, rel) pairs."""
    return max(a[0], b[0]), max(a[1], b[1])


def _bf16op_parity(torch, device) -> dict:
    """(a): every bf16-operand instance of B1, B2 and B3 against its plain
    version on the card; the launch counters hold only bf16-operand
    launches afterwards.  Returns the worst (abs, rel) error per kernel."""
    import numpy as np
    from softx_2020_200_tpu_torch.ops import gls_kernel as gk1
    from softx_2020_200_tpu_torch.ops import lattice_gd_kernel as gk3
    from softx_2020_200_tpu_torch.ops import lattice_kernel as lk
    from softx_2020_200_tpu_torch.ops import persistent_tiles as pt
    counters = _launch_counters()
    for cls in counters.values():
        cls.launches, cls.launches_by_shape = 0, {}
    worst = {name: (0.0, 0.0) for name in KERNELS}

    def note(name, w):
        worst[name] = _worse(worst[name], w)

    for dim, degree, q1d, cells in B1_BF16OP:
        space = _space(dim, degree, cells, seed=dim * 10 + degree)
        op = _gls_ops(torch, space, device, lsic=dim == 2, n_q1d=q1d,
                      builds=("bf16",))["bf16"]
        check(op.layout is None, "B1 bf16 parity mesh took the lattice path")
        x = _inputs(torch, op, seed=dim * 10 + degree)
        reg = q1d is None and (dim, degree) in gk1.REGISTER_SHAPES
        label = f"B1 d={dim} k={degree}{f' q={q1d}' if q1d else ''} bf16op"
        note("gls_element", _check_bf16op(
            torch, label, space.n_elements,
            lambda sk: _bf16op_calls(torch, op, x, sk), reg, dim))
    for dim, degree, q1d, cells in B2_BF16OP:
        space = _lattice(dim, degree, cells)
        op = _gls_ops(torch, space, device, lsic=dim == 3, n_q1d=q1d,
                      builds=("bf16",))["bf16"]
        check(op.layout is not None, "B2 bf16 parity lattice took B1")
        x = _inputs(torch, op, seed=dim * 10 + degree)
        reg = (dim, degree, q1d) in lk.REGISTER_SHAPES
        note("gls_lattice", _check_bf16op(
            torch, f"B2 d={dim} k={degree} q={q1d} bf16op",
            space.n_elements, lambda sk: _bf16op_calls(torch, op, x, sk),
            reg))
    # a box and a sheared lattice of one size: the box takes REGISTERS by
    # default, the sheared one STAGED, and the entry point refuses a
    # REGISTERS launch of the bf16-operand instance on the sheared tables
    for dim, cells in B2_SHEARED:
        for shear in (0.0, B2_SHEAR):
            space = _lattice(dim, 1, cells, shear=shear)
            op = _gls_ops(torch, space, device, n_q1d=2,
                          builds=("bf16",))["bf16"]
            k, E = op.kernel, space.n_elements
            x = _inputs(torch, op, seed=dim)
            label = f"B2 d={dim} {'sheared' if shear else 'box'} bf16op"
            kernel, plain, _ = _bf16op_calls(torch, op, x)
            rels = []
            err = _check_outputs(torch, label, E, kernel,
                                 _outputs(torch, plain), BF16OP_RTOL, rels)
            note("gls_lattice", (err, max(rels)))
            routes = {r for key, (r, _) in k._plans.items()}
            want = pt.STAGED if shear else pt.REGISTERS
            print(f"  {label:44s} E={E:7d} routes taken {sorted(routes)}")
            check(routes == {want}, f"{label}: routes {routes}")
        ue = op._rows(x["u"])
        up, fq = op._rows(x["prev"]), op._fq_rows(x["fq"])
        out = torch.empty_like(ue)
        err = lk.get_build().lib.gls_lattice_launch(
            dim, 1, 2, 1, 2, 2, ue.data_ptr(), ue.data_ptr(), up.data_ptr(),
            fq.data_ptr(), k.tables.data_ptr(), k._host_tables_ptr,
            out.data_ptr(), E, pt.row_pitch(ue), k.nu, k.h, 1.5, 20.0, 1, 1,
            1, 0, 0, 0, pt.REGISTERS, 1, pt.LOAD_CP_ASYNC_4,
            int(k.laplacian_free), torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        print(f"  B2 d={dim} sheared bf16op: a REGISTERS launch returns CUDA "
              f"error {err}")
        check(err == 1, f"bf16op REGISTERS on sheared tables returned {err}")
    for dim, cells, periodic in B3_BF16OP + ((*B3_SHEARED, False),):
        shear = B2_SHEAR if (dim, cells) == B3_SHEARED else 0.0
        op = _gd_operator(torch, dim, cells, periodic, device,
                          torch.bfloat16, shear)
        check(op.layout_v is not None and op.kernel._host_tables is not None,
              "B3 bf16 parity lattice took SoA")
        if shear:
            Jinv = op.kernel.geometry[0]
            check(np.abs(Jinv - np.diag(np.diag(Jinv))).max() > 0,
                  "B3 sheared lattice has a diagonal J^-1")
        x = _gd_inputs(torch, op, seed=dim)
        label = (f"B3 d={dim}{' periodic' if periodic else ''}"
                 f"{' sheared' if shear else ''} bf16op")
        note("gd_lattice", _check_bf16op(
            torch, label, op.space_v.n_elements,
            lambda sk: _gd_bf16op_calls(torch, op, x, sk),
            dim in gk3.REGISTER_DIMS))
    other = {f"{name}: {key}" for name, cls in counters.items()
             for key in cls.launches_by_shape if not key[4].endswith("bf16op")}
    check(not other, f"bf16 parity launched other instances: {other}")
    launches = [cls.launches for cls in counters.values()]
    print(f"  bf16-operand launches {launches}, every one a bf16op instance")
    return worst


def _time_builds(torch, name, label, ops, x, times, forced_settings):
    """(b): at one full-width shape, the bf16-operand instances compared
    with their plain version and then timed (kernel, forced routes, plain
    primal and tangent) beside the float32 tangent and, for B1 and B2, the
    bf16-state tangent (timed here where phases 3b-3d did not)."""
    from softx_2020_200_tpu_torch.ops.persistent_tiles import state_rows
    op16 = ops["bf16"]
    gd = name == "gd_lattice"
    calls = ((lambda sk: _gd_bf16op_calls(torch, op16, x, sk)) if gd else
             (lambda sk: _bf16op_calls(torch, op16, x, sk)))
    kernel, plain, forced = calls(False)
    E = (op16.space_v if gd else op16.space).n_elements
    has_reg, dim = forced_settings
    want, rels = _outputs(torch, plain), []
    err = _check_settings(torch, f"{label} bf16op", E, kernel, forced, want,
                          has_reg, dim, BF16OP_RTOL, rels)
    del want
    _time_variants(torch, label, E, kernel, plain, times, None,
                   _settings(has_reg, dim), forced,
                   time_plain=("primal bf16op", "tangent bf16op"))
    row = times[label]
    if "tangent" not in row:
        op32 = ops["f32"]
        k = op32.kernel
        x32 = {key: v.float() for key, v in x.items()}
        if gd:
            ue, due = op32._rows(x32["x"]), op32._rows(x32["dx"])
            base = {"tangent": lambda: k.tangent(ue, due, 1.5)}
        else:
            if op32.layout is None:
                ue, due = op32._soa(x32["u"]), op32._soa(x32["v"])
                st = [op32.xe_soa, op32._soa(x32["prev"]),
                      op32._fq_soa(x32["fq"]), op32.h]
            else:
                ue, due = op32._rows(x32["u"]), op32._rows(x32["v"])
                st = [op32._rows(x32["prev"]), op32._fq_rows(x32["fq"])]
            s16 = [state_rows(t) for t in [ue] + st]
            base = {"tangent": lambda: k.tangent(ue, due, *st, 1.5, 20.0),
                    "tangent bf16": lambda: k.tangent(s16[0], due, *s16[1:],
                                                      1.5, 20.0)}
        _time_variants(torch, label, E, base, base, times, time_plain=False)
    return err, max(rels)


def _operator_check(torch, name, label, ops, x) -> dict:
    """(c): the bf16 operator's residual and frozen-tau (GD: exact)
    Jacobian action, through its gathers, kernel and assembly, against
    the float32 operator's on the same (rounded) inputs; the bf16 run
    launches exactly one primal_bf16op and one tangent_bf16op instance."""
    counters = _launch_counters()
    cls = counters[name]
    op16, op32 = ops["bf16"], ops["f32"]
    x32 = {key: v.float() for key, v in x.items()}
    out = {}
    for build, op, z in (("bf16", op16, x), ("f32", op32, x32)):
        cls.launches, cls.launches_by_shape = 0, {}
        if name == "gd_lattice":
            r = op.residual_free(z["x"], z["vprev"], z["fq"], 1.5)
            d = op.jvp(op.linearize(z["x"], z["vprev"], z["fq"], 1.5),
                       z["dx"])
        else:
            r = op.residual_free(z["u"], z["prev"], z["fq"], 1.5, 20.0)
            d = op.jvp(op.linearize(z["u"], z["prev"], z["fq"], 1.5, 20.0),
                       z["v"])
        torch.cuda.synchronize()
        out[build] = (r, d, dict(cls.launches_by_shape))
    variants = sorted(key[4] for key in out["bf16"][2])
    res = {"kernel": name, "label": label}
    for i, what in enumerate(("residual", "jvp")):
        err, rel = _rel(torch, out["bf16"][i], out["f32"][i])
        res[what] = rel
        print(f"  {label:32s} {what:8s} bf16 operator against float32: "
              f"max_abs_err {err:.3e} rel {rel:.3e} ({out['bf16'][i].dtype})")
        check(out["bf16"][i].dtype == torch.bfloat16
              and bool(torch.isfinite(out["bf16"][i].float()).all())
              and rel < BF16_OPERATOR_RTOL,
              f"{label} bf16 {what}: rel {rel:.3e}")
    print(f"  {label:32s} launches of the bf16 operator: "
          f"{out['bf16'][2]}")
    check(variants == ["primal_bf16op", "tangent_bf16op"]
          and all(n == 1 for n in out["bf16"][2].values()),
          f"{label}: the bf16 operator launched {out['bf16'][2]}")
    return res


def _matvec_builds(torch, ops, x) -> list:
    """(d): the lattice matvec (strided gather, B2's tangent, strided
    scatter) at the 64^3 Q1 box in the three builds: seconds per matvec
    (CUDA events around one call, the host's launches included; and the
    device time of a CUDA graph of 20) and GDoF/s."""
    rows = []
    for build in ("f32", "state", "bf16"):
        op = ops[build]
        z = {key: v.to(op.dtype) for key, v in x.items()}
        st = op.linearize(z["u"], z["prev"], z["fq"], 1.5, 20.0)
        cls = _launch_counters()["gls_lattice"]
        cls.launches_by_shape = {}
        op.jvp(st, z["v"])
        torch.cuda.synchronize()
        variant = [key[4] for key in cls.launches_by_shape]
        call = _median_ms(torch, lambda: op.jvp(st, z["v"]))
        graph = _graph_ms(torch, lambda: op.jvp(st, z["v"]))
        n_dofs = op.n_nodes * op.nc
        rows.append({"build": build, "variant": variant, "n_dofs": n_dofs,
                     "s_per_matvec": call / 1e3,
                     "device_s_per_matvec": graph / 1e3,
                     "gdofs": n_dofs / (call / 1e3) / 1e9,
                     "device_gdofs": n_dofs / (graph / 1e3) / 1e9})
        print(f"  64^3 Q1 matvec {build:5s} ({variant}): "
              f"{call / 1e3:.6e} s per matvec, {rows[-1]['gdofs']:.3f} "
              f"GDoF/s; device {graph / 1e3:.6e} s, "
              f"{rows[-1]['device_gdofs']:.3f} GDoF/s ({n_dofs} DoF)")
        del st, z
        torch.cuda.empty_cache()
    want = {"f32": ["tangent"], "state": ["tangent_bf16"],
            "bf16": ["tangent_bf16op"]}
    check(all(r["variant"] == want[r["build"]] for r in rows),
          f"matvec builds launched {[r['variant'] for r in rows]}")
    return rows


def phase_bf16_operands(torch, device, times: dict) -> tuple[dict, dict]:
    """Phase 14.  Returns the worst (abs, rel) error of the bf16-operand
    instances per kernel, and the operator and matvec results; adds the
    full-width times to ``times`` (kernel -> label -> row)."""
    from softx_2020_200_tpu_torch.ops import gls_kernel as gk1
    from softx_2020_200_tpu_torch.ops import lattice_gd_kernel as gk3
    from softx_2020_200_tpu_torch.ops import lattice_kernel as lk
    print("== phase 14: the bf16 operand build (B1, B2, B3 with every "
          "operand in bf16; instances against their plain version within "
          f"{BF16OP_RTOL:g} of scale, operators against float32 within "
          f"{BF16_OPERATOR_RTOL:g})")
    t0 = time.perf_counter()
    worst = _bf16op_parity(torch, device)
    print(f"  (a) done at {time.perf_counter() - t0:.1f} s")
    results = {"operators": [], "matvec": None}
    for name, label, (kind, *spec) in BF16OP_SHAPES:
        if kind == "gd":
            dim, cells, periodic = spec
            ops = {b: _gd_operator(torch, dim, cells, periodic, device, dt)
                   for b, dt in (("f32", torch.float32),
                                 ("bf16", torch.bfloat16))}
            x = _gd_inputs(torch, ops["bf16"], seed=5)
            settings = (dim in gk3.REGISTER_DIMS, None)
        else:
            if kind == "lattice":
                dim, degree, cells, periodic = spec
                space = _lattice(dim, degree, cells, periodic=periodic)
                q1d = degree + 1
                settings = ((dim, degree, q1d) in lk.REGISTER_SHAPES, None)
            else:
                dim, degree, cells = spec
                space = _space(dim, degree, cells, seed=7)
                settings = ((dim, degree) in gk1.REGISTER_SHAPES, dim)
            builds = (("f32", "state", "bf16") if label == "3D Q1 box 64^3"
                      else ("f32", "bf16"))
            ops = _gls_ops(torch, space, device, builds=builds)
            x = _inputs(torch, ops["bf16"], seed=3)
        note = _time_builds(torch, name, label, ops, x,
                            times.setdefault(name, {}), settings)
        worst[name] = _worse(worst[name], note)
        if label in ("3D Q1 TGV 32^3", "2D Q2 Taylor-Couette r5",
                     "2D Q2-Q1 256^2 (GD cavity)"):
            results["operators"].append(
                _operator_check(torch, name, label, ops, x))
        if label == "3D Q1 box 64^3":
            results["matvec"] = _matvec_builds(torch, ops, x)
        del ops, x
        torch.cuda.empty_cache()
        print(f"  {label} done at {time.perf_counter() - t0:.1f} s")
    for name in KERNELS:
        row_times = times.get(name, {})
        for label, row in row_times.items():
            if "tangent bf16op" not in row:
                continue
            bound = (_bound_gd if name == "gd_lattice" else None)
            dims = _shape_keys(name)[label]
            b = {what: (bound(dims[0], what, row["E"])[0] if bound else
                        _bound(*dims[:2], what, row["E"],
                               name == "gls_lattice", dims[2])[0])
                 for what in ("tangent", "tangent bf16", "tangent bf16op")
                 if name != "gd_lattice" or what != "tangent bf16"}
            got = {what: row[what]["ms"] for what in b if what in row}
            print(f"  {name} {label:32s} tangent ms: "
                  + ", ".join(f"{w.replace('tangent', '') or ' f32'} "
                              f"{got.get(w, float('nan')):.4f} (bound "
                              f"{b[w]:.4f})" for w in b))
    print(f"  bf16op worst (abs, rel) per kernel: {worst}")
    return worst, results


# ----------------------------------------------------------------------
# phase 15: the sphere at its own base mesh
# ----------------------------------------------------------------------
DECKS.update({
    # BASELINE #5 as written (Q1, channel_with_sphere at initial
    # refinement 2 = 14,720 cells on the forest, steady, Kelly on
    # velocity refining 15 % up to level 6 and 400,000 cells, Newton
    # 1e-6, FGMRES to 2,000 steps with 'auto' -> forest GMG), cut: no
    # field output, and Newton 1e-5 in place of 1e-6, which float32 does
    # not reach on this deck (C4, C7): the JAX package's f32 run of the
    # deck as written stalls its base solve at 1.34e-6 after the 12
    # iterations the deck allows
    "sphere_r2.prm": ("examples/sphere_re100.prm", [
        ("output frequency", "0"), ("tolerance", "1e-5"),
        _VERBOSE_NEWTON]),
})
# B1's shapes that phase 15's run launched and earlier passes did not
# time: label -> (dim, degree, points per axis), filled by its pass
SPHERE_SHAPES: dict = {}
# FGMRES iterations per solve against the JAX package's float32 run with
# tau frozen, relative (float32 sums in another order move a count)
SPHERE_KRYLOV_RTOL = 0.10


def phase_sphere(torch, times_b1: dict) -> tuple[list, float]:
    """Phase 15: the sphere deck at its own base mesh through the 3D app:
    the cells after each adaptation within CELLS_RTOL, each solve's
    Newton iterations within 1 and FGMRES within SPHERE_KRYLOV_RTOL of
    the JAX package's float32 run with tau frozen, no GMG eviction
    (``drive_app``; the JAX run has none), every solve under its
    tolerance, and the force on the sphere after each cycle within
    FORCE_KELLY_RTOL of the JAX package's float64 run (Cd = 8 F_x / pi);
    then B1 at every shape the run launched.  Returns the run and the
    worst max-abs error of the per-shape pass."""
    print("== phase 15: the sphere (BASELINE #5) at its own base mesh, "
          "14,720 cells, Kelly cycles on the forest (B1, forest GMG)")
    deck = "sphere_r2.prm"
    ref = JAX_REFERENCE[deck]
    states = {}
    res = drive_app(torch, 3, deck, "gls_element", b1_states=states)
    _cells(deck, res["out"], ref)
    got = _per_solve(deck, res["out"], len(ref["newton_per_solve"]))
    print(f"  Newton iterations per solve {[n for n, _ in got]} (JAX CPU "
          f"f32 {ref['newton_per_solve']}), FGMRES per solve "
          f"{[k for _, k in got]} (JAX {ref['krylov_per_solve']})")
    for i, ((n, k), nr, kr) in enumerate(zip(got, ref["newton_per_solve"],
                                             ref["krylov_per_solve"])):
        check(abs(n - nr) <= 1, f"{deck}: solve {i + 1}: {n} Newton "
              f"iterations against {nr}")
        check(_close(k, kr, SPHERE_KRYLOV_RTOL), f"{deck}: solve {i + 1}: "
              f"{k} FGMRES iterations against {kr}")
    _check_converged(deck, res)
    forces = [tuple(float(x) for x in f) for f in re.findall(
        rf"^Force boundary 3 : {_NUM} {_NUM} {_NUM}", res["out"], re.M)]
    check(len(forces) == len(ref["forces"]), f"{deck}: {len(forces)} "
          "force lines")
    for cycle, (f, want) in enumerate(zip(forces, ref["forces"])):
        err = max(abs(a - b) for a, b in zip(f, want)) / max(map(abs, want))
        print(f"  cycle {cycle}: Cd {8 * f[0] / math.pi:.5f} (JAX CPU f64 "
              f"{8 * want[0] / math.pi:.5f}), force difference {err:.2e} "
              f"of its largest component (bound {FORCE_KELLY_RTOL:g})")
        check(err <= FORCE_KELLY_RTOL, f"{deck}: cycle {cycle}: force {f}")
    worst = _recorded_shapes(torch, states, times_b1, "sphere",
                             SPHERE_SHAPES)
    return [res], worst


# ----------------------------------------------------------------------
# phase 16: the validation drivers (scripts/run_*_torch.py) at full width
# ----------------------------------------------------------------------
# B1's shapes that phase 16's cylinder launched and earlier passes did
# not time: label -> (dim, degree, points per axis), filled by its pass
VALIDATION_SHAPES: dict = {}
# The drivers' cases, by scripts/jax_driver_references.py CASE ... (JAX
# on the CPU, with JAX_ENABLE_X64=1 for f64 and without for f32), and
# the JAX package's own chip run of the cavity (docs/cavity256q2_run.log)
JAX_REFERENCE.update({
    # run_cavity.py at CAV_N=256 CAV_ORDER=2 on the JAX package's chip
    # (f32): 9 Newton and 207 linear iterations
    "cavity256q2": {"u_min": -0.3249844014644623,
                    "max_profile_err": 0.003821596088409429,
                    "newton": 9},
    # tgv --n 48 --steps 3 (dt 0.02): 4 solves (the BDF2 startup's two,
    # then one per step), GMG on 3 levels, f64 and f32 both 8 Newton and
    # 27 FGMRES iterations (6, 7, 7, 7); KE and enstrophy per step, f64.
    # The JAX package's chip run at 96^3 (docs/tgv96_r5_run.log lines
    # 3-5) printed KE 1.247224e-01, 1.247128e-01, 1.247034e-01.  The JAX
    # package's f64 run at 96^3 was not made: it holds the full-size
    # state (a Krylov basis of 201 x 3,538,944 f64, 5.7 GB) on the CPU,
    # and at 8x the cells of 48^3 (2.9 minutes) its time is estimated at
    # 23 minutes or more, not measured
    "tgv48": {"kinetic_energy": [1.239234931e-01, 1.239138615e-01,
                                 1.239043249e-01],
              "enstrophy": [3.721395925e-01, 3.721569180e-01,
                            3.722053588e-01],
              "fgmres_per_newton_f32": 3.375, "levels": 3},
    # cylinder --order 2 --refine 4 --steps 10 --frequency 5 (dt 0.01):
    # 11 solves, forest GMG with the Q1 p-level; f64: 26 Newton and 151
    # FGMRES iterations, cells 9,951 and 14,328; f32: 35 Newton and 194
    # FGMRES, cells 9,987 and 14,457, the impulsive start's first two
    # solves at the 8-iteration cap above 1e-6.  Forces on the cylinder
    # per step, f64
    "cylinder_q2r4": {
        "cells_f32": [9987, 14457], "solves_above_tolerance_f32": 2,
        "forces": [(-2.416911137e+00, 3.456618890e-03),
                   (9.653737779e-02, 1.772770933e-04),
                   (1.056671534e-01, -2.151687999e-04),
                   (1.059778598e-01, -1.892769720e-04),
                   (1.081254724e-01, -2.296136177e-04),
                   (1.118298647e-01, -2.827396724e-04),
                   (1.150418918e-01, -3.563451984e-04),
                   (1.193747671e-01, -4.361907402e-04),
                   (1.237522933e-01, -5.192336060e-04),
                   (1.281308155e-01, -5.922941144e-04)]},
})
# The cavity at 256^2 in float64, Newton to 7.0e-12 in 7 iterations
# (scripts/run_cavity_torch.py --device cpu --dtype float64, on the
# CPU): the discrete solution the float32 runs approach.  The card's
# float32 run stops at the float32 floor of the Newton residual (7.0e-8
# against the deck's 1e-8) within 4.9e-7 of it along the centerline;
# the JAX package's chip run lies 3.1e-4 from it in u_min and 7.7e-4
# in the largest profile error (ROADMAP C11).  Phase 16 holds the card
# to this solution within the bounds the JAX chip run was to be held
# to, and prints its distance from the JAX chip run beside them
CAVITY_F64 = {"u_min": -0.3246718669950805,
              "max_profile_err": 0.0030477628008858393}
CAVITY_UMIN_ATOL = 2e-4
CAVITY_PROFILE_ATOL = 3e-4


def drive_script(torch, name: str, argv: list, kernel: str,
                 b1_states: dict | None = None) -> dict:
    """Run the driver ``scripts/<name>.py`` on the card through its own
    ``run(parse_args(argv))`` (float32), with every kernel's launch count
    set to 0 just before and read just after; its output is echoed.
    Checks that it launched ``kernel`` and no other, and that multigrid
    was never evicted.  Returns the driver's summary with the launch
    counts, memory and seconds, as ``drive_app``."""
    import importlib
    mod = importlib.import_module(name)
    with contextlib.ExitStack() as stack:
        if b1_states is not None:
            stack.enter_context(_b1_states(b1_states))
        res, out, seconds, launches, by_shape = _counted(
            torch, lambda: mod.run(mod.parse_args(
                argv + ["--device", "cuda", "--dtype", "float32"])))
    res.update(deck=name, out=out, seconds=seconds, launches=launches,
               launches_by_shape=by_shape,
               peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20)
    print(f"  wall {seconds:.2f} s, peak device memory "
          f"{res['peak_mib']:.1f} MiB, launches {launches}")
    check("GMG stagnated" not in out and res["gmg_evictions"] == 0,
          f"{name}: multigrid stagnated and fell back to block-Jacobi")
    _check_launched(name, launches, kernel)
    return res


def _validation_cavity(torch, tmp: str) -> dict:
    """(a) The cavity at Q2 256^2 in full: u_min and the largest profile
    error at Ghia's stations against the float64 solution (beside their
    distance from the JAX package's chip run), Newton against that
    run's."""
    ref = JAX_REFERENCE["cavity256q2"]
    res = drive_script(torch, "run_cavity_torch",
                       ["--out", os.path.join(tmp, "cavity.dat")],
                       "gls_lattice")
    print(f"  {res['cells']} cells, {res['dofs']} DoF, {res['levels']} GMG "
          f"levels; Newton {res['newton_iters']} (JAX chip {ref['newton']}),"
          f" {res['linear_iters']} FGMRES, {res['s_per_newton']:.4f} s per "
          f"Newton iteration, solves above tolerance "
          f"{res['solves_above_tolerance']}, Newton residuals "
          + " ".join(f"{r:.3e}" for r in res["newton_residuals"]))
    check(res["levels"] == 6, f"cavity: {res['levels']} GMG levels")
    check(abs(res["newton_iters"] - ref["newton"]) <= 1,
          f"cavity: {res['newton_iters']} Newton iterations")
    for key, atol in (("u_min", CAVITY_UMIN_ATOL),
                      ("max_profile_err", CAVITY_PROFILE_ATOL)):
        want = CAVITY_F64[key]
        d = abs(res[key] - want)
        print(f"  {key} {res[key]:.7f}: f64 {want:.7f}, difference {d:.2e} "
              f"(bound {atol:g}); JAX chip f32 {ref[key]:.7f}, difference "
              f"{abs(res[key] - ref[key]):.2e} (C11)")
        check(d <= atol, f"cavity: {key} {res[key]} against {want}")
    return res


def _validation_tgv(torch, tmp: str) -> dict:
    """(b) The TGV at 48^3 for 3 steps: KE and enstrophy per step against
    the JAX package's f64 run, FGMRES per Newton iteration against its
    f32 run, GMG on 3 levels."""
    ref = JAX_REFERENCE["tgv48"]
    res = drive_script(torch, "run_tgv_torch",
                       ["--n", "48", "--t-end", "0.06", "--every", "1",
                        "--out", os.path.join(tmp, "tgv.dat")],
                       "gls_lattice")
    check(res["levels"] == ref["levels"], f"tgv48: {res['levels']} levels")
    _check_energies("tgv48", res["out"])
    ke = [row[1] for row in res["series"]]
    for step, (k, r) in enumerate(zip(ke, ref["kinetic_energy"]), start=1):
        check(_close(k, r, ENERGY_RTOL), f"tgv48 step {step}: KE {k}")
    lin = res["fgmres_iterations"] / res["newton_iterations"]
    want = ref["fgmres_per_newton_f32"]
    print(f"  FGMRES per Newton iteration {lin:.3f} (JAX CPU f32 "
          f"{want:.3f}, bound +-1); solves above tolerance "
          f"{res['solves_above_tolerance']}")
    check(abs(lin - want) <= 1.0, f"tgv48: {lin:.3f} FGMRES per Newton "
          "iteration")
    check(res["solves_above_tolerance"] == 0, "tgv48: a solve above "
          "tolerance")
    return res


def _validation_cylinder(torch, tmp: str, states: dict) -> dict:
    """(c) The Q2 cylinder at refinement 4 (6,912 cells) for 10 steps with
    Kelly every 5: cells after each adaptation against the JAX package's
    f32 run, Cd and Cl per step against its f64 run."""
    ref = JAX_REFERENCE["cylinder_q2r4"]
    res = drive_script(torch, "run_cylinder_torch",
                       ["--t-end", "0.1", "--frequency", "5", "--every",
                        "5", "--out", os.path.join(tmp, "cyl.dat")],
                       "gls_element", b1_states=states)
    got = [a["cells"] for a in res["adaptations"]]
    print(f"  cells after each adaptation: {got} (JAX CPU f32 "
          f"{ref['cells_f32']})")
    check(len(got) == len(ref["cells_f32"]), f"cylinder: {len(got)} "
          "adaptations")
    for g, w in zip(got, ref["cells_f32"]):
        check(abs(g - w) <= CELLS_RTOL * w, f"cylinder: cells {got}")
    check(len(res["series"]) == len(ref["forces"]),
          f"cylinder: {len(res['series'])} steps")
    for step, ((_, fx, fy), (rx, ry)) in enumerate(
            zip(res["series"], ref["forces"]), start=1):
        err = max(abs(fx - rx), abs(fy - ry)) / max(abs(rx), abs(ry))
        print(f"  step {step:2d}: Cd {20 * fx: .6e} Cl {20 * fy: .6e}; JAX "
              f"CPU f64 Cd {20 * rx: .6e} Cl {20 * ry: .6e}; difference "
              f"{err:.2e} of |Cd|")
        check(err <= FORCE_KELLY_RTOL, f"cylinder step {step}: force "
              f"({fx}, {fy}) against ({rx}, {ry})")
    print(f"  Newton {res['newton_iterations']}, FGMRES "
          f"{res['fgmres_iterations']} in {res['newton_solves']} solves, "
          f"{res['solves_above_tolerance']} above tolerance (JAX CPU f32 "
          f"{ref['solves_above_tolerance_f32']})")
    check(res["solves_above_tolerance"]
          <= ref["solves_above_tolerance_f32"],
          "cylinder: more solves above tolerance than the JAX f32 run")
    return res


def phase_validation(torch, times_b1: dict) -> tuple[list, list, float]:
    """Phase 16: the three validation drivers through their own ``run``
    on the card at full width for a short window (the cavity in full,
    the TGV at 48^3 for 3 steps, the Q2 cylinder for 10 steps with two
    adaptations), each held to the JAX package; then B1 at every shape
    the cylinder launched.  Returns the B1 runs, the B2 runs and the
    worst max-abs error of the per-shape pass."""
    print("== phase 16: the validation drivers (scripts/run_*_torch.py): "
          "cavity Q2 256^2, TGV 48^3, Q2 cylinder with Kelly")
    states = {}
    with tempfile.TemporaryDirectory() as tmp:
        print(" -- (a) lid-driven cavity Re 400, Q2 256^2 (B2, p- and "
              "h-GMG)")
        cav = _validation_cavity(torch, tmp)
        print(" -- (b) TGV Re 1600 at 48^3, 3 BDF2 steps (B2, lattice GMG)")
        tgv = _validation_tgv(torch, tmp)
        print(" -- (c) cylinder Re 100, Q2 refinement 4, 10 steps, Kelly "
              "every 5 (B1, forest GMG with the Q1 p-level)")
        cyl = _validation_cylinder(torch, tmp, states)
    for r in (cav, tgv, cyl):
        r.pop("series", None)
    worst = _recorded_shapes(torch, states, times_b1, "validation",
                             VALIDATION_SHAPES)
    return [cyl], [cav, tgv], worst


# ----------------------------------------------------------------------
# the variants of each kernel's timed shapes, as _time_variants names
# them, and the launch variant each one's time is per launch of
VARIANTS = {"gls_element": ("primal", "tangent", "node blocks",
                            "tangent bf16", "node blocks bf16",
                            "primal bf16op", "tangent bf16op",
                            "node blocks bf16op"),
            "gls_lattice": ("primal", "tangent", "node blocks",
                            "tangent bf16", "node blocks bf16",
                            "primal bf16op", "tangent bf16op",
                            "node blocks bf16op"),
            "gd_lattice": ("primal", "tangent", "primal bf16op",
                           "tangent bf16op")}
LAUNCH_MODE = {"primal": "primal", "tangent": "tangent",
               "node blocks": "probe", "tangent bf16": "tangent_bf16",
               "node blocks bf16": "probe_bf16",
               "primal bf16op": "primal_bf16op",
               "tangent bf16op": "tangent_bf16op",
               "node blocks bf16op": "probe_bf16op"}


def _shape_keys(kernel: str) -> dict:
    """label -> (dim, degree, points per axis) of a kernel's timed shapes
    (B3: the velocity degree)."""
    if kernel == "gls_lattice":
        return {s[0]: s[1:4] for s in B2_SHAPES + B2_LEVELS}
    if kernel == "gd_lattice":
        return {s[0]: (s[1], 2, 3) for s in B3_SHAPES}
    return {**{s[0]: (s[1], s[2], s[2] + 1) for s in B1_SHAPES},
            **FOREST_SHAPES, **SHARD_SHAPES, **SPHERE_SHAPES,
            **VALIDATION_SHAPES}


def _shape_bound(kernel: str, label: str, what: str, E: int):
    dim, degree, q1d = _shape_keys(kernel)[label]
    if kernel == "gd_lattice":
        return _bound_gd(dim, what, E)
    return _bound(dim, degree, what, E, kernel == "gls_lattice", q1d)


def _by_shape(times: dict, kernel: str, launches: dict) -> list:
    """Per timed shape: its main-path launches per variant (``launches``
    maps (dim, degree, points per axis, E, variant[, route]) to a count,
    summed over routes) and, per variant, the kernel's, the parent's
    (None without one) and the plain version's times, the forced routes'
    times and the bound (None for a variant not timed at that shape,
    which the main path did not launch there: phase 12's forest shapes
    time the float32-state variants).  Fails if a main-path launch is at
    a shape, or of a variant at a shape, that is not timed (and so was
    not compared at its own E either)."""
    keys, out = _shape_keys(kernel), []
    timed = {(*keys[label], row["E"]) for label, row in times.items()}
    untimed = sorted({k[:5] for k in launches if tuple(k[:4]) not in timed})
    check(not untimed, f"{kernel}: main-path launches at shapes that are "
          f"neither compared nor timed (dim, degree, points per axis, E, "
          f"variant): {untimed}")
    for label, row in times.items():
        dim, degree, q1d = keys[label]
        E = row["E"]
        counts = {}
        for key, n in launches.items():
            if tuple(key[:4]) == (dim, degree, q1d, E):
                counts[key[4]] = counts.get(key[4], 0) + n
        entry = {"label": label, "E": E, "launches": {
            LAUNCH_MODE[what]: counts.get(LAUNCH_MODE[what], 0)
            for what in VARIANTS[kernel]}}
        if "routes" in row:
            entry["routes"] = row["routes"]
        for what in VARIANTS[kernel]:
            r = row.get(what)
            if r is None:
                n = entry["launches"][LAUNCH_MODE[what]]
                check(n == 0, f"{kernel}: {n} main-path {what} launches at "
                      f"{label}, where it is not timed")
                entry[what] = None
                continue
            b, by = _shape_bound(kernel, label, what, E)
            entry[what] = {"ms": r["ms"], "ms_parent": r.get("ms_parent"),
                           "plain_ms": r["plain_ms"], "bound_ms": b,
                           "bound_by": by, "call_ms": r["call_ms"],
                           "call_ms_parent": r.get("call_ms_parent"),
                           "settings": {n: t for n, (t, _) in
                                        r["settings"].items()}}
            if kernel == "gd_lattice":
                entry[what]["bound_ms_dense"] = _bound_gd(dim, what, E,
                                                          dense=True)[0]
        out.append(entry)
    return out


def _device_seconds(by_shape: list, key: str, kernel: str) -> float | None:
    """Device seconds of one main-path run: the main-path launches of each
    timed shape times the device time per launch (``key`` "ms" or
    "ms_parent"; a probe launch is 1/(nn*c) of the node blocks' time).
    The parent's sum counts the float32 variants, which it has (the bf16
    variants have no main-path launches but those of phase 10's bf16-state
    decks).  None where a time is missing."""
    total = 0.0
    for entry in by_shape:
        n = entry["launches"]
        for what in VARIANTS[kernel]:
            mode = LAUNCH_MODE[what]
            if (key == "ms_parent" and "_bf16" in mode
                    or entry[what] is None):
                continue
            ms = entry[what][key]
            if ms is None:
                return None
            if mode.startswith("probe"):
                dim, degree, _ = _shape_keys(kernel)[entry["label"]]
                ms /= (degree + 1) ** dim * (dim + 1)
            total += n[mode] * ms / 1e3
    return total


def _entry(name, source, replaces, runs, worst, row, bound, times=None,
           bf16op=None):
    """One kernel's line: its tangent (the Krylov matvec, most of its
    launches) at its main-path shape ``row``: kernel and plain times, and
    (bound ms, bound by); launches in total and per (dim, degree, points
    per axis, E, variant[, route]) over the main-path ``runs``; with
    ``times`` the parent's time (``ms_parent``, null without
    ``--parent``), every timed shape (the bf16-operand instances'
    variants where phase 14 timed them) and the device seconds of one
    main-path run, the kernel's and the parent's; ``bf16op`` phase 14's
    worst errors of the bf16-operand instances against their plain
    version (``max_abs_err`` stays the float32 and bf16-state one)."""
    bound_ms, bound_by = bound
    t = row["tangent"]
    per_shape = {}
    for r in runs:
        for key, n in r["launches_by_shape"][name].items():
            per_shape[key] = per_shape.get(key, 0) + n
    entry = {"name": name, "route": "cuda",
             "source": os.path.relpath(source, ROOT), "replaces": replaces,
             "launches": sum(r["launches"][name] for r in runs),
             "max_abs_err": worst, "ms": t["ms"], "plain_ms": t["plain_ms"],
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
             "launches_by_shape": {",".join(map(str, k)): n
                                   for k, n in sorted(per_shape.items())}}
    if bf16op is not None:
        entry["bf16op"] = bf16op
    if times is not None:
        entry["ms_parent"] = t.get("ms_parent")
        entry["by_shape"] = _by_shape(times, name, per_shape)
        for key in ("ms", "ms_parent"):
            entry[f"main_path_device_s{key[2:]}"] = _device_seconds(
                entry["by_shape"], key, name)
    return entry


def _print_bounds(times: dict, kernel: str) -> None:
    tag = {"gls_element": "B1", "gls_lattice": "B2", "gd_lattice": "B3"}
    for label, row in times.items():
        for what in (w for w in VARIANTS[kernel] if w in row):
            b, by = _shape_bound(kernel, label, what, row["E"])
            parent = row[what].get("ms_parent")
            dense = ""
            if kernel == "gd_lattice":
                d = _shape_keys(kernel)[label][0]
                dense = (f" (dense count "
                         f"{_bound_gd(d, what, row['E'], True)[0]:.4f} ms)")
            print(f"  bound {tag[kernel]} {label:32s} "
                  f"{what:11s} {b:9.4f} ms ({by}){dense}; kernel "
                  f"{row[what]['ms']:9.4f} ms" + (
                      f", parent {parent:9.4f} ms" if parent is not None
                      else ""))


PHASES = ("2", "3", "3b", "3c", "3d", "4", "5", "6", "7", "8", "9", "10",
          "11", "12", "13", "14", "15", "16")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--write-decks", metavar="DIR",
                        help="write the main-path decks to DIR and stop")
    parser.add_argument("--phases", metavar="LIST",
                        help="run only these phases (comma-separated, "
                        "e.g. 2,3c; phase 1 always runs, phase 2 with any "
                        "of 3-3d, 14 and 15, and phases 7 and 12 with 13, "
                        "which holds its runs to theirs); prints no "
                        "contract line")
    parser.add_argument("--parent", metavar="DIR",
                        help="another checkout (a git archive of the parent "
                        "commit): time its B1 and B2 through its own "
                        "wrappers beside this one's (ms_parent)")
    args = parser.parse_args(argv)
    if args.write_decks:
        write_decks(args.write_decks)
        return 0
    only = set(args.phases.split(",")) if args.phases else set(PHASES)
    check(only <= set(PHASES), f"unknown phases {only - set(PHASES)}")
    if only & {"3", "3b", "3c", "3d", "14", "15", "16"}:
        only.add("2")
    if "13" in only:
        only |= {"7", "12"}

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # the package, and the drivers of phase 16 (scripts/run_*_torch.py)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()

    def stamp(phase: str) -> None:
        print(f"-- phase {phase} done at {time.perf_counter() - t0:.1f} s")

    smi = phase_environment(torch)
    parent = load_parent(args.parent) if args.parent else None
    if parent is not None:
        print(f"parent: softx_2020_200_tpu_torch from {parent.root}")
    spaces = _host_spaces(only)
    if "2" in only:
        phase_build(parent)
        stamp("2")
    worst_b1 = worst_b2 = 0.0
    times_b1, times_b2, times_b3 = {}, {}, {}
    if "3" in only:
        worst_b1 = phase_kernel_parity(torch, device)
        stamp("3")
    if "3b" in only:
        times_b1, worst_at_scale = phase_kernel_times(torch, device, spaces,
                                                       parent)
        worst_b1 = max(worst_b1, worst_at_scale)
        _print_bounds(times_b1, "gls_element")
        stamp("3b")
    if "3c" in only:
        times_b2, worst_b2 = phase_lattice_kernel(torch, device, spaces,
                                                  parent)
        _print_bounds(times_b2, "gls_lattice")
        stamp("3c")
    if "3d" in only:
        times_b3, worst_b3 = phase_gd_kernel(torch, device, parent)
        _print_bounds(times_b3, "gd_lattice")
        stamp("3d")
    b1_runs, b2_runs, b3_runs = [], [], []
    for name, phase, runs in (("4", phase_couette, b1_runs),
                              ("5", phase_tgv, b2_runs),
                              ("6", phase_tgv_gmg, b2_runs),
                              ("7", phase_mms_gmg, b2_runs),
                              ("8", phase_gd_cavity, b3_runs),
                              ("9", phase_gd_tgv, b3_runs)):
        if name in only:
            res = phase(torch)
            runs.extend(res if isinstance(res, list) else [res])
            stamp(name)
    if "10" in only:
        b1_bf16, b2_bf16 = phase_bf16_decks(
            torch, {r["deck"]: r for r in b1_runs + b2_runs})
        b1_runs += b1_bf16
        b2_runs += b2_bf16
        stamp("10")
    if "11" in only:
        b1_opt, b2_opt, b3_opt, worst_em = phase_options(
            torch, {r["deck"]: r for r in b2_runs + b3_runs})
        b1_runs += b1_opt
        b2_runs += b2_opt
        b3_runs += b3_opt
        worst_b1 = max(worst_b1, worst_em["gls_element"])
        worst_b2 = max(worst_b2, worst_em["gls_lattice"])
        stamp("11")
    if "12" in only:
        b1_forest, worst_forest = phase_forest(torch, times_b1)
        b1_runs += b1_forest
        worst_b1 = max(worst_b1, worst_forest)
        _print_bounds({k: v for k, v in times_b1.items()
                       if k in FOREST_SHAPES}, "gls_element")
        stamp("12")
    if "13" in only:
        b1_shard, worst_shard = phase_sharded(
            torch, times_b1, {r["deck"]: r for r in b1_runs + b2_runs})
        b1_runs += b1_shard
        worst_b1 = max(worst_b1, worst_shard)
        _print_bounds({k: v for k, v in times_b1.items()
                       if k in SHARD_SHAPES}, "gls_element")
        stamp("13")
    if "14" in only:
        worst_bf16op, bf16_results = phase_bf16_operands(
            torch, device, {"gls_element": times_b1, "gls_lattice": times_b2,
                            "gd_lattice": times_b3})
        stamp("14")
    if "15" in only:
        b1_sphere, worst_sphere = phase_sphere(torch, times_b1)
        b1_runs += b1_sphere
        worst_b1 = max(worst_b1, worst_sphere)
        _print_bounds({k: v for k, v in times_b1.items()
                       if k in SPHERE_SHAPES}, "gls_element")
        stamp("15")
    if "16" in only:
        b1_val, b2_val, worst_val = phase_validation(torch, times_b1)
        b1_runs += b1_val
        b2_runs += b2_val
        worst_b1 = max(worst_b1, worst_val)
        _print_bounds({k: v for k, v in times_b1.items()
                       if k in VALIDATION_SHAPES}, "gls_element")
        stamp("16")
    if only != set(PHASES):
        print(f"phases {sorted(only)} passed; no contract line")
        return 0

    from softx_2020_200_tpu_torch.ops import (gls_kernel, lattice_gd_kernel,
                                              lattice_kernel)
    b1, b2 = times_b1["2D Q2 Taylor-Couette r5"], times_b2["3D Q1 TGV 32^3"]
    b3 = times_b3["2D Q2-Q1 256^2 (GD cavity)"]
    # the bf16-operand instances: phase 14's worst errors against their
    # plain version, its operator checks and (B2) the three matvec builds
    bf16op = {}
    for name in KERNELS:
        err, rel = worst_bf16op[name]
        bf16op[name] = {"max_abs_err": err, "max_rel_err": rel,
                        "operators": [r for r in bf16_results["operators"]
                                      if r["kernel"] == name]}
    bf16op["gls_lattice"]["matvec_64cubed"] = bf16_results["matvec"]
    entries = [
        _entry("gls_element", gls_kernel.SOURCE,
               "softx_2020_200_tpu/ops/pallas_gls.py:218", b1_runs, worst_b1,
               b1, _bound(2, 2, "tangent", b1["E"], False), times_b1,
               bf16op["gls_element"]),
        _entry("gls_lattice", lattice_kernel.SOURCE,
               "softx_2020_200_tpu/ops/pallas_lattice.py:103", b2_runs,
               worst_b2, b2, _bound(3, 1, "tangent", b2["E"], True),
               times_b2, bf16op["gls_lattice"]),
        _entry("gd_lattice", lattice_gd_kernel.SOURCE,
               "softx_2020_200_tpu/ops/pallas_lattice_gd.py:59", b3_runs,
               worst_b3, b3, _bound_gd(2, "tangent", b3["E"]), times_b3,
               bf16op["gd_lattice"]),
    ]
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
