#!/usr/bin/env python3
"""The JAX package's runs of BASELINE #2's convergence ladders: the decks
of its own tests (``MMS_DECK``, ``TRANSIENT_MMS_DECK`` and ``TC_DECK``
imported from ``tests/test_mms_convergence.py``, ``BASE`` from
``tests/test_gd_solver.py`` with the extra of its
``test_gd_mms_spatial_convergence`` built as that test builds it), level
by level as ``scripts/run_convergence_torch.py`` runs them (its
``levels`` and flags), through ``GLSNavierStokesSolver.solve`` (the
uniform cycles), ``solve_steady`` or ``run_transient`` and
``GDNavierStokesSolver.solve_steady``.  The reference that
``tests/test_torch_convergence.py`` and ``chip_smoke.py`` phase 17 hold
the PyTorch package's ladders to.  JAX on the CPU only.

    JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=<repo> \\
        python3 scripts/jax_convergence_references.py --max-q1 64 \\
        --max-q2 32 --max-gd 32 --max-tc 3 --tc-forest "" \\
        --time-refines 2 --min-dt 0.05

Without ``JAX_ENABLE_X64`` the run is float32, with the Newton
tolerances of the PyTorch driver's ``F32_TOLERANCE`` and its linear
floors ``F32_MIN_RESIDUAL``.  Prints, per level,
cells and DoF, the velocity and pressure L2 errors and their rates, the
Newton and Krylov iterations, and on Taylor-Couette the torque on the
inner and outer walls; then every row as one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(SCRIPTS)
sys.path[:0] = [ROOT, SCRIPTS]

import numpy as np  # noqa: E402

import jax_driver_references as drivers  # noqa: E402
import run_convergence_torch as port  # noqa: E402


def gd_mms_extra() -> str:
    """The extra deck text of the JAX package's
    ``tests/test_gd_solver.py::test_gd_mms_spatial_convergence``, built as
    that test builds it."""
    bcs = "subsection boundary conditions\n  set number = 4\n"
    for i in range(4):
        bcs += f"""  subsection bc {i}
    set id = {i}
    set type = function
    subsection u
      set Function expression = sin(pi*x)^2 * sin(2*pi*y)
    end
    subsection v
      set Function expression = -sin(2*pi*x) * sin(pi*y)^2
    end
  end
"""
    bcs += "end\n"
    return bcs + """
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


def _x64() -> bool:
    import jax
    return bool(jax.config.jax_enable_x64)


def _prm(text: str, key: str, workdir: str):
    """As the PyTorch driver's ``_prm``: float32's Newton tolerance and
    linear floor of ladder ``key`` unless x64, no field output, tables
    under ``workdir``."""
    from softx_2020_200_tpu.core.parameters import SimulationParameters
    prm = SimulationParameters.from_text(text, dim=2)
    if not _x64():
        prm.nonlinear_solver.tolerance = port.F32_TOLERANCE[key]
        prm.linear_solver.minimum_residual = port.F32_MIN_RESIDUAL[key]
    sc = prm.simulation_control
    sc.output_frequency = 0
    sc.output_path = workdir + os.sep
    return prm


def _counts(solves: list) -> dict:
    return {"newton": sum(n for n, _ in solves),
            "krylov": sum(k for _, k in solves),
            "solves": len(solves)}


def mms_rows(group: list[dict], workdir: str) -> list[dict]:
    from tests.test_mms_convergence import MMS_DECK
    lv0 = group[0]
    prm = _prm(MMS_DECK.format(order=lv0["order"], refine=lv0["refine"],
                               cycles=lv0["cycles"]),
               lv0["ladder"], workdir)
    s = drivers.counted_solver(prm)
    rows, seen = [], [0]

    def on_cycle(solver, u, t):
        lv = group[len(rows)]
        ev, ep = solver.l2_errors(u)
        rows.append(dict(lv, cells=int(solver.space.n_elements),
                         dofs=int(solver.space.n_dofs(3)),
                         error_velocity=float(ev), error_pressure=float(ep),
                         **_counts(solver.solves[seen[0]:])))
        seen[0] = len(solver.solves)

    s.solve(on_cycle=on_cycle)
    return rows


def gd_row(lv: dict, workdir: str) -> dict:
    from softx_2020_200_tpu.solvers.gd import GDNavierStokesSolver
    from tests.test_gd_solver import BASE
    prm = _prm(BASE.format(nu=1.0, refine=lv["refine"],
                           extra=gd_mms_extra()),
               "gd", workdir)
    s = GDNavierStokesSolver(prm)
    x, res = s.solve_steady()
    ev, ep = s.l2_errors(x)
    return dict(lv, cells=int(s.op.space_v.n_elements), dofs=int(s.op.n_dofs),
                error_velocity=float(ev), error_pressure=float(ep),
                newton=int(res.n_iterations),
                krylov=int(res.linear_iters), solves=1)


def tc_row(lv: dict, workdir: str) -> dict:
    from softx_2020_200_tpu.solvers import postprocessing as post
    from tests.test_mms_convergence import TC_DECK
    prm = _prm(TC_DECK.format(refine=lv["refine"]),
               "tc", workdir)
    ls = prm.linear_solver
    if lv.get("krylov"):
        ls.max_krylov_vectors = lv["krylov"]
        ls.max_iters = 20000
    if lv.get("forest"):
        prm.mesh_adaptation.type = "kelly"
        ls.preconditioner = "gmg"
        ls.max_iters = 20000
    s = drivers.counted_solver(prm)
    u, _ = s.solve_steady(verbose=False)
    ev, ep = s.l2_errors(u)
    faces = s.space.boundary_faces
    ti, to = (float(np.asarray(post.torques_on_boundary(
        s.op, u, faces[b], center=[0.0, 0.0]))[0]) for b in (0, 1))
    return dict(lv, cells=int(s.space.n_elements),
                dofs=int(s.space.n_dofs(3)), error_velocity=float(ev),
                error_pressure=float(ep), torque_inner=ti, torque_outer=to,
                **_counts(s.solves))


def time_row(lv: dict, workdir: str) -> dict:
    from tests.test_mms_convergence import TRANSIENT_MMS_DECK
    prm = _prm(TRANSIENT_MMS_DECK.format(
        method=lv["ladder"], dt=lv["dt"], tend=lv["tend"],
        refine=lv["refine"]),
        "time", workdir)
    s = drivers.counted_solver(prm)
    u = s.run_transient(verbose=False,
                        history_from_exact=lv["ladder"] == "bdf3")
    ev, ep = s.l2_errors(u, t=s.control.time)
    return dict(lv, cells=int(s.space.n_elements),
                dofs=int(s.space.n_dofs(3)), error_velocity=float(ev),
                error_pressure=float(ep), steps=int(s.control.iteration),
                **_counts(s.solves))


def run_ladder(name: str, args, todo=None) -> list[dict]:
    """The JAX package's rows of ladder ``name`` at the levels ``todo``
    (by default those the PyTorch driver would run with ``args``), with
    their rates."""
    todo = port.levels(name, args) if todo is None else todo
    done = []
    with tempfile.TemporaryDirectory() as workdir:
        while todo:
            lv = todo[0]
            if "cycles" in lv:
                group = [x for x in todo if x["refine"] == lv["refine"]
                         and x["route"].startswith("cycle") ==
                         lv["route"].startswith("cycle")]
                new = mms_rows(group, workdir)
            else:
                group = [lv]
                if name == "gd":
                    new = [gd_row(lv, workdir)]
                elif name == "tc":
                    new = [tc_row(lv, workdir)]
                else:
                    new = [time_row(lv, workdir)]
            for row in new:
                done.append(port._with_rates(row, done))
            todo = todo[len(group):]
    return done


def line(row: dict) -> str:
    extra = ""
    if row.get("overlap_rel_diff") is not None:
        extra += (f"  same level by {row['repeats']}: "
                  f"{row['overlap_rel_diff']:.2e}")
    if "torque_inner" in row:
        extra += (f"  torque inner {row['torque_inner']:.9e} outer "
                  f"{row['torque_outer']:.9e} (exact {port.TC_TORQUE:.6f})")
    return (f"{row['ladder']:6s} {row['label']:16s} {row['route']:18s} "
            f"cells {row['cells']:7d} dofs {row['dofs']:7d}  e_u "
            f"{row['error_velocity']:.9e} e_p {row['error_pressure']:.9e}"
            f"  rate_u {port._fmt(row.get('rate_velocity'), '.4f')} rate_p "
            f"{port._fmt(row.get('rate_pressure'), '.4f')}  solves "
            f"{row['solves']} newton {row['newton']} krylov "
            f"{row['krylov']}" + extra)


def main(argv=None) -> int:
    args = port.parse_args(argv)
    import jax
    print(f"JAX {jax.__version__}, x64 {_x64()}", flush=True)
    rows = []
    for name in (n for n in args.ladders.split(",") if n):
        for row in run_ladder(name, args):
            print(line(row), flush=True)
            rows.append(row)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
