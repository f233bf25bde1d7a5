"""The flow past a sphere (BASELINE #5, ``examples/sphere_re100.prm``)
through both packages on the CPU in float64, at the deck's base mesh
with initial refinement 0 (230 cells of 3D Q1 on the forest, the 6-hex
O-grid with its spherical manifold) and tau frozen in the Jacobian
(the linearization of the port's CUDA kernels).

The base solve (block-Jacobi FGMRES: the base mesh has no coarser forest
level) takes the same Newton iterations in both packages, FGMRES within
one per Newton iteration, and the same force on the sphere; Kelly's
indicators and flags on the JAX package's solution are the JAX
package's, and refine the forest to the same 468 cells.  The script
that runs the deck on the card, ``scripts/run_sphere_torch.py``, edits
the deck as its flags say and never imports jax.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from softx_2020_200_tpu.core.parameters import \
    SimulationParameters as JaxParameters
from softx_2020_200_tpu.solvers import kelly as jax_kelly
from softx_2020_200_tpu.solvers import postprocessing as jax_post
from softx_2020_200_tpu.solvers.base import \
    GLSNavierStokesSolver as JaxSolver
from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
from softx_2020_200_tpu_torch.solvers import kelly
from softx_2020_200_tpu_torch.solvers import postprocessing as post
from softx_2020_200_tpu_torch.solvers.base import (GLSNavierStokesSolver,
                                                   adapt_forest)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECK = os.path.join(ROOT, "examples", "sphere_re100.prm")
SCRIPT = os.path.join(ROOT, "scripts", "run_sphere_torch.py")
SPHERE = 3
FORCE_RTOL = 1e-6


def _prm(cls):
    """The deck at initial refinement 0, one steady solve, no output,
    tau frozen in the Jacobian."""
    prm = cls.from_file(DECK, dim=3)
    prm.mesh.initial_refinement = 0
    prm.simulation_control.number_mesh_adaptation = 0
    prm.simulation_control.output_frequency = 0
    prm.forces.calculate_forces = False
    prm.stabilization.frozen_tau_jacobian = True
    return prm


@pytest.fixture(scope="module")
def jax_base():
    """The JAX package's base solve: (solver, u, Newton result)."""
    s = JaxSolver(_prm(JaxParameters))
    u, res = s.solve_steady()
    return s, np.asarray(u), res


def test_base_solve_matches_jax(jax_base):
    a, ua, ra = jax_base
    b = GLSNavierStokesSolver(_prm(SimulationParameters), device="cpu",
                              dtype=torch.float64)
    assert b.space.n_elements == a.space.n_elements == 230
    assert b.precond_kind == a.precond_kind == "block_jacobi"
    ub, rb = b.solve_steady()
    na, nb = int(ra.n_iterations), int(rb.n_iterations)
    ka, kb = int(ra.linear_iters), int(rb.linear_iters)
    assert nb == na
    assert abs(kb - ka) <= na, (kb, ka)
    assert rb.res_history[nb] <= b.prm.nonlinear_solver.tolerance
    fa = np.asarray(jax_post.forces_on_boundary(
        a.op, ua, a.space.boundary_faces[SPHERE]))
    fb = post.forces_on_boundary(b.op, ub, b.space.boundary_faces[SPHERE])
    np.testing.assert_allclose(fb.numpy(), fa, rtol=0,
                               atol=FORCE_RTOL * np.abs(fa).max())


def test_kelly_flags_on_jax_solution_match_jax(jax_base):
    a, ua, _ = jax_base
    b = GLSNavierStokesSolver(_prm(SimulationParameters), device="cpu",
                              dtype=torch.float64)
    ma = b.prm.mesh_adaptation
    ea = np.asarray(jax_kelly.kelly_estimate(
        a.op, ua, variable=ma.variable, nc_faces=a._nc_faces))
    eb = kelly.kelly_estimate(
        SimpleNamespace(space=b.space, dim=3, xe=b.space.element_coords(),
                        elem_nodes=b.space.elem_nodes), ua,
        variable=ma.variable, nc_faces=b._nc_faces)
    np.testing.assert_allclose(eb, ea, rtol=1e-10, atol=0)
    kw = dict(fraction_type=ma.fraction_type,
              refine_fraction=ma.fraction_refinement,
              coarsen_fraction=ma.fraction_coarsening)
    for fa, fb in zip(jax_kelly.flag_cells(ea, **kw),
                      kelly.flag_cells(eb, **kw)):
        np.testing.assert_array_equal(fb, fa)
    adapt_forest(b.forest, eb, ma, 3)
    mesh, _, _ = b.forest.build_mesh()
    assert mesh.n_cells == 468


def test_run_sphere_script_edits_the_deck_without_jax():
    """``scripts/run_sphere_torch.py`` imports neither jax nor the JAX
    package, and its flags replace the deck's own values (the flagship
    ladder's here) and turn the field output off."""
    code = f"""
import argparse, importlib.util, sys
spec = importlib.util.spec_from_file_location("run_sphere_torch",
                                              {SCRIPT!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
text = mod.deck_text(argparse.Namespace(refine=3, cycles=4,
                                        max_elements=2600000, fraction=0.2))
for line in ("set initial refinement = 3", "set number mesh adapt      = 4",
             "set max number elements  = 2600000",
             "set fraction refinement  = 0.2",
             "set output frequency       = 0"):
    assert line in text, line
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
       or m.split(".")[0] == "softx_2020_200_tpu"]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")

