"""The PyTorch package's GD velocity-block multigrid against the JAX
package's, on the CPU in float64 with the same inputs made with numpy.

- the lattice hierarchy of the GD cavity at refinement 4 (level sizes,
  Dirichlet masks, interpolation masters/weights, injection);
- the nearest-face boundary-id remap on a side that carries two ids;
- one V-cycle, linearized at the same velocity, applied to the same
  residual (1e-10 relative);
- building and applying the preconditioner, and the Jacobian action,
  read nothing back from the device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softx_2020_200_tpu.core.parameters import \
    SimulationParameters as JaxParameters
from softx_2020_200_tpu.ops import gd_multigrid as jax_gmg
from softx_2020_200_tpu.solvers.gd import \
    GDNavierStokesSolver as JaxGDSolver
from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
from softx_2020_200_tpu_torch.ops import gd_multigrid as port_gmg
from softx_2020_200_tpu_torch.solvers.gd import GDNavierStokesSolver
from tests.test_torch_multigrid import _host_reads

torch.set_num_threads(1)

# the GD cavity of tests/test_gd_solver.py
CAVITY = """
subsection simulation control
  set method = steady
end
subsection physical properties
  set kinematic viscosity = 0.05
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
{bcs}subsection non-linear solver
  set verbosity = quiet
  set tolerance = 1e-8
  set max iterations = 10
end
subsection linear solver
  set verbosity = quiet
  set relative residual = 1e-4
  set minimum residual = 1e-11
  set max krylov vectors = 100
  set preconditioner = {precond}
end
subsection test
  set enable = true
end
"""


LID = "    subsection u\n      set Function expression = 1\n    end\n"


def cavity(refine=4, precond="gmg", kinds=("noslip",) * 3 + ("function",)):
    """The cavity deck with boundary ``i`` of type ``kinds[i]`` (a
    ``function`` boundary is the moving lid)."""
    bcs = f"subsection boundary conditions\n  set number = {len(kinds)}\n"
    for i, kind in enumerate(kinds):
        bcs += (f"  subsection bc {i}\n    set id = {i}\n    set type = "
                f"{kind}\n" + (LID if kind == "function" else "") + "  end\n")
    return CAVITY.format(refine=refine, precond=precond, bcs=bcs + "end\n")


def pair(text, dim=2):
    """(JAX solver, port solver on the CPU in float64) on one deck."""
    ja = JaxGDSolver(JaxParameters.from_text(text, dim=dim))
    po = GDNavierStokesSolver(SimulationParameters.from_text(text, dim=dim),
                              device="cpu", dtype=torch.float64)
    return ja, po


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def test_hierarchy_matches_jax():
    ja, po = pair(cavity())
    levels_a, consts_a = jax_gmg.build_gd_hierarchy(ja)
    levels = po.mg_levels
    assert po.precond_kind == "gmg" and po.newton_cfg.flexible
    assert len(levels) == len(levels_a) == 2      # 16^2 -> 8^2 (64 cells)
    for li, (lvl, la, ca) in enumerate(zip(levels, levels_a, consts_a)):
        assert lvl.op.N == la.N and lvl.op.nn == la.nn
        np.testing.assert_array_equal(lvl.mask.numpy(),
                                      np.asarray(ca["mask"]))
        assert _rel(lvl.op.gB, la.gB) < 1e-14
        if li == 0:
            continue
        for key in ("masters", "weights", "inject"):
            np.testing.assert_array_equal(getattr(lvl, key).numpy(),
                                          np.asarray(ca[key]))


def test_mixed_side_boundary_remap():
    """A geometric side carrying two boundary ids (an outlet patch and a
    wall): each coarse face takes the id of the nearest fine boundary
    face, so the outlet is never swallowed by a coarse Dirichlet mask;
    the coarse masks equal the JAX package's."""
    text = cavity(kinds=("noslip", "outlet", "noslip", "function",
                         "noslip"))
    ja, po = pair(text)
    for s, mesh in ((ja, ja.op.space_v.mesh), (po, po.op.space_v.mesh)):
        for row in mesh.boundary_faces:
            if int(row[1]) == 1:
                yc = mesh.vertices[mesh.cells[int(row[0])]][:, 1].mean()
                if yc > 0.5:
                    row[2] = 4
        s.setup()
    assert po.precond_kind == "gmg" and len(po.mg_levels) == 2
    cmesh = po.mg_levels[1].op.space.mesh
    right = [r for r in cmesh.boundary_faces if int(r[1]) == 1]
    assert right
    for r in right:
        yc = cmesh.vertices[cmesh.cells[int(r[0])]][:, 1].mean()
        assert int(r[2]) == (4 if yc > 0.5 else 1), (yc, int(r[2]))
    masks = [np.asarray(c["mask"]) for c in
             jax_gmg.build_gd_hierarchy(ja)[1]]
    for lvl, want in zip(po.mg_levels, masks):
        np.testing.assert_array_equal(lvl.mask.numpy(), want)


@pytest.mark.parametrize("alpha0", [0.0, 20.0], ids=["steady", "bdf"])
def test_vcycle_matches_jax(alpha0):
    ja, po = pair(cavity(refine=5))
    levels_a, consts_a = jax_gmg.build_gd_hierarchy(ja)
    assert len(po.mg_levels) == len(levels_a) == 3
    rng = np.random.default_rng(2)
    N = po.op.Nv
    v_lin = rng.standard_normal((N, 2)) * 0.5
    r = rng.standard_normal((N, 2))
    mask = np.asarray(consts_a[0]["mask"])
    r[mask] = 0.0
    z_ref = jax_gmg.make_gd_vcycle(levels_a, consts_a)(
        jnp.asarray(v_lin), alpha0)(jnp.asarray(r))
    z = port_gmg.make_gd_vcycle(po.mg_levels)(
        torch.as_tensor(v_lin), alpha0)(torch.as_tensor(r))
    assert _rel(z, z_ref) < 1e-10


def test_vcycle_reads_nothing_back():
    """Building the block-triangular preconditioner at a Newton iterate
    (the V-cycle's level states and smoothers), applying it, and the
    Jacobian action read nothing back from the device: a Newton
    iteration's only reads are the Krylov loop's own."""
    _, po = pair(cavity(refine=5))
    op = po.op
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal(op.n_dofs))
    r = torch.as_tensor(rng.standard_normal(op.n_dofs))
    fq = po._source_q(0.0)
    with _host_reads() as reads:
        apply = po._precond_builder(10.0)(x)
        z = apply(r)
        state = op.linearize(x, po._zero_prev, fq, 10.0)
        jz = op.jvp(state, z)
    assert reads[0] == 0
    assert bool(torch.isfinite(z).all()) and bool(torch.isfinite(jz).all())
