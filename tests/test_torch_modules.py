"""The PyTorch package's boundary handling, hanging-node constraints,
geometry, assembly, preconditioners and post-processing against the JAX
package, module by module, on the same float64 inputs made with numpy
(1e-12 relative unless stated).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softx_2020_200_tpu.core.parameters import \
    SimulationParameters as JaxParameters
from softx_2020_200_tpu.fem import constraints as jax_constraints
from softx_2020_200_tpu.fem import geometry as jax_geometry
from softx_2020_200_tpu.fem import mesh as jax_mesh
from softx_2020_200_tpu.fem.dof import FESpace as JaxFESpace
from softx_2020_200_tpu.fem.forest import Forest
from softx_2020_200_tpu.ops import operators as jax_operators
from softx_2020_200_tpu.ops import preconditioners as jax_pc
from softx_2020_200_tpu.solvers import boundary as jax_boundary
from softx_2020_200_tpu.solvers import gls as jax_gls
from softx_2020_200_tpu.solvers import postprocessing as jax_post
from softx_2020_200_tpu.solvers.base import \
    GLSNavierStokesSolver as JaxSolver
from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
from softx_2020_200_tpu_torch.fem import constraints as port_constraints
from softx_2020_200_tpu_torch.fem import geometry as port_geometry
from softx_2020_200_tpu_torch.fem import mesh as port_mesh
from softx_2020_200_tpu_torch.fem.dof import FESpace
from softx_2020_200_tpu_torch.ops import operators as port_operators
from softx_2020_200_tpu_torch.ops import preconditioners as port_pc
from softx_2020_200_tpu_torch.solvers import boundary as port_boundary
from softx_2020_200_tpu_torch.solvers import gls as port_gls
from softx_2020_200_tpu_torch.solvers import postprocessing as port_post
from softx_2020_200_tpu_torch.solvers.base import GLSNavierStokesSolver

torch.set_num_threads(1)

RTOL = 1e-12
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) / scale < rtol


def _t(a):
    return torch.as_tensor(np.array(a))


# ----------------------------------------------------------------------
# boundary conditions
# ----------------------------------------------------------------------
BCS = {
    # curved shell: time-dependent function values inside, rotated slip
    # frames on the outer circle
    "shell_slip": ("hyper_shell", "0, 0 : 0.25 : 1 : 12 : true", 2, """
  set number = 2
  subsection bc 0
    set id = 0
    set type = function
    subsection u
      set Function expression = -y*exp(-t)
    end
    subsection v
      set Function expression = x*cos(t)
    end
  end
  subsection bc 1
    set id = 1
    set type = slip
  end"""),
    # box: axis-aligned slip walls become masks; noslip and outlet
    "box_slip": ("hyper_cube", "0 : 1 : true", 3, """
  set number = 4
  subsection bc 0
    set id = 0
    set type = function
    subsection u
      set Function expression = y*z + t
    end
  end
  subsection bc 1
    set id = 1
    set type = outlet
  end
  subsection bc 2
    set id = 2
    set type = slip
  end
  subsection bc 3
    set id = 4
    set type = noslip
  end"""),
}


def _bc_deck(grid, args, bcs):
    return (f"subsection mesh\n  set type = dealii\n  set grid type = {grid}"
            f"\n  set grid arguments = {args}\n  set initial refinement = 1"
            f"\nend\nsubsection boundary conditions{bcs}\nend\n")


@pytest.mark.parametrize("case", sorted(BCS))
def test_boundary_handler_matches_jax(case):
    grid, args, dim, bcs = BCS[case]
    text = _bc_deck(grid, args, bcs)
    pa = JaxParameters.from_text(text, dim=dim)
    pb = SimulationParameters.from_text(text, dim=dim)
    ma = jax_mesh.generate_mesh(grid, args, dim=dim, initial_refinement=1)
    mb = port_mesh.generate_mesh(grid, args, dim=dim, initial_refinement=1)
    sa, sb = JaxFESpace(ma, 2), FESpace(mb, 2)
    ba = jax_boundary.BoundaryHandler(sa, pa.boundary_conditions)
    bb = port_boundary.BoundaryHandler(sb, pb.boundary_conditions)
    np.testing.assert_array_equal(bb.mask.numpy(), np.asarray(ba.mask))
    assert bb.n_slip == ba.n_slip
    assert (bb.n_slip > 0) == (case == "shell_slip")

    rng = np.random.default_rng(11)
    N, c = sa.n_nodes, dim + 1
    u = rng.standard_normal((N, c))
    R = rng.standard_normal((N, c))
    blocks = rng.standard_normal((N, c, c))
    for t in (0.0, 0.7):
        _close(bb.values(t), ba.values(t))
        _close(bb.constrain(_t(u), t), ba.constrain(jnp.asarray(u), t))
    _close(bb.slip_project(_t(u)), ba.slip_project(jnp.asarray(u)))
    _close(bb.slip_residual(_t(R), _t(u)),
           ba.slip_residual(jnp.asarray(R), jnp.asarray(u)))
    _close(bb.slip_project_blocks(_t(blocks)),
           ba.slip_project_blocks(jnp.asarray(blocks)))


# ----------------------------------------------------------------------
# hanging-node constraints (the port builds them from a forest's
# non-conforming faces; this slice's meshes have none)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dim,degree", [(2, 1), (2, 2), (3, 1)])
def test_hanging_constraints_match_jax(dim, degree):
    f = Forest(jax_mesh.hyper_cube(0.0, 1.0, colorize=True, dim=dim))
    f.refine(f.all_leaves())
    f.refine([(0, (1,) + (0,) * dim)])
    mesh, _, ncf = f.build_mesh()
    sa = JaxFESpace(mesh, degree)
    sb = FESpace(mesh, degree)
    ha = jax_constraints.build_hanging_constraints(sa, ncf)
    hb = port_constraints.build_hanging_constraints(sb, ncf)
    assert hb.n == ha.n > 0
    np.testing.assert_array_equal(hb.ids.numpy(), np.asarray(ha.ids))
    np.testing.assert_array_equal(hb.masters.numpy(), np.asarray(ha.masters))
    _close(hb.weights, ha.weights)
    u = np.random.default_rng(dim).standard_normal((sa.n_nodes, dim + 1))
    _close(hb.distribute(_t(u)), ha.distribute(jnp.asarray(u)))
    _close(hb.distribute_transpose(_t(u)),
           ha.distribute_transpose(jnp.asarray(u)))
    empty = port_constraints.build_hanging_constraints(sb, [])
    assert empty.n == 0
    assert torch.equal(empty.distribute(_t(u)), _t(u))


# ----------------------------------------------------------------------
# geometry and assembly
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dim", [2, 3])
def test_geometry_and_assembly_match_jax(dim):
    rng = np.random.default_rng(dim)
    J = rng.standard_normal((5, 4, dim, dim)) + 3 * np.eye(dim)
    da, ia = jax_geometry.det_and_inv(jnp.asarray(J))
    db, ib = port_geometry.det_and_inv(_t(J))
    _close(db, da)
    _close(ib, ia)
    for face in range(2 * dim):
        ma, na = jax_geometry.face_measure_and_normal(jnp.asarray(J), face)
        mb, nb = port_geometry.face_measure_and_normal(_t(J), face)
        _close(mb, ma)
        _close(nb, na)

    space = JaxFESpace(jax_mesh.hyper_shell([0.0] * dim, 0.5, 1.0)
                       .refine_uniform(1 if dim == 2 else 0), 2)
    en, N = space.elem_nodes, space.n_nodes
    amap_a = jax_operators.build_assembly_map(en, N)
    amap_b = port_operators.build_assembly_map(en, N)
    np.testing.assert_array_equal(amap_b.idx, np.asarray(amap_a.idx))
    r_el = rng.standard_normal(en.shape + (dim + 1,))
    want = jax_operators.scatter_add_elements(jnp.asarray(r_el),
                                              jnp.asarray(en), N,
                                              amap=amap_a)
    got = port_operators.assemble(_t(r_el), torch.as_tensor(amap_b.idx))
    _close(got, want)
    np.testing.assert_array_equal(
        port_operators.node_multiplicity(en, N),
        jax_operators.node_multiplicity(en, N))


# ----------------------------------------------------------------------
# node-block preconditioners
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["jacobi", "block_jacobi"])
def test_node_block_preconditioners_match_jax(kind):
    rng = np.random.default_rng(4)
    N, c = 40, 4
    blocks = rng.standard_normal((N, c, c)) + 4 * np.eye(c)
    mask = rng.random((N, c)) < 0.2
    v = rng.standard_normal((N, c))
    pa = jax_pc.build_from_node_blocks(kind, jnp.asarray(blocks),
                                       jnp.asarray(mask))
    pb = port_pc.build_from_node_blocks(kind, _t(blocks), _t(mask))
    _close(pb.apply(_t(v)), pa.apply(jnp.asarray(v)))
    sa = jax_pc.node_blocks_to_state(kind, jnp.asarray(blocks),
                                     jnp.asarray(mask))
    sb = port_pc.node_blocks_to_state(kind, _t(blocks), _t(mask))
    _close(port_pc.apply_node_block_state(sb, _t(v)),
           jax_pc.apply_node_block_state(sa, jnp.asarray(v)))


# ----------------------------------------------------------------------
# post-processing
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dim,degree", [(2, 2), (3, 1)])
def test_postprocessing_matches_jax(dim, degree):
    if dim == 2:
        def mk(m):
            return m.hyper_shell([0.0, 0.0], 0.25, 1.0, 12).refine_uniform(1)
    else:
        def mk(m):
            return m.subdivided_hyper_rectangle([0.0] * 3, [1.0] * 3,
                                                [3, 2, 2], True, dim=3)
    sa, sb = JaxFESpace(mk(jax_mesh), degree), FESpace(mk(port_mesh), degree)
    oa = jax_gls.GLSOperator(sa, nu=0.03, dtype=jnp.float64)
    ob = port_gls.GLSOperator(sb, nu=0.03)
    u = np.random.default_rng(dim).standard_normal((sa.n_nodes, dim + 1))
    ua, ub = jnp.asarray(u), _t(u)
    center = np.array([0.1, -0.2, 0.3])[:dim]
    for bid, faces in sorted(sa.boundary_faces.items()):
        _close(port_post.forces_on_boundary(ob, ub, sb.boundary_faces[bid]),
               jax_post.forces_on_boundary(oa, ua, faces))
        _close(port_post.torques_on_boundary(ob, ub, sb.boundary_faces[bid],
                                             center),
               jax_post.torques_on_boundary(oa, ua, faces, center))
    _close(port_post.kinetic_energy(ob, ub), jax_post.kinetic_energy(oa, ua))
    _close(port_post.enstrophy(ob, ub), jax_post.enstrophy(oa, ua))
    _close(port_post.vorticity_field(ob, ub),
           jax_post.vorticity_field(oa, ua))
    _close(port_post.q_criterion_field(ob, ub),
           jax_post.q_criterion_field(oa, ua))


# ----------------------------------------------------------------------
# a whole solve through rotated slip frames
# ----------------------------------------------------------------------
def test_rotated_slip_solve_matches_jax(tmp_path):
    from tests.test_slip_cfl import ROTATION_SLIP_DECK
    text = ROTATION_SLIP_DECK.format(refine=1).replace(
        "subsection linear solver\n",
        "subsection linear solver\n  set preconditioner = block_jacobi\n")
    text = text.replace("subsection simulation control\n",
                        "subsection simulation control\n"
                        f"  set output path = {tmp_path}/\n", 1)
    ja = JaxSolver(JaxParameters.from_text(text, dim=2))
    po = GLSNavierStokesSolver(SimulationParameters.from_text(text, dim=2))
    assert po.bh.n_slip > 0
    ua, ra = ja.solve_steady(verbose=False)
    up, rp = po.solve_steady(verbose=False)
    _close(up, ua, rtol=1e-8)
    assert rp.n_iterations == int(ra.n_iterations)
    assert abs(rp.linear_iters - int(ra.linear_iters)) <= 1
