"""The PyTorch package's forest, hanging-node constraints, Kelly
estimator, solution transfer and gmsh reader against the JAX package's,
on the CPU in float64.

Every case runs the same seeded marks, fields and files through both
packages.  The forest and the gmsh reader are host copies (held to their
originals by ``tests/test_torch_host_copies.py``); these cases hold what
they compute on meshes with hanging faces: 2D and 3D, Q1 and Q2, across
the rotated seams of the cylinder's O-grid and of a two-cell base with a
rotated frame, and across a periodic seam.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softx_2020_200_tpu.fem import constraints as jax_constraints
from softx_2020_200_tpu.fem import forest as jax_forest
from softx_2020_200_tpu.fem import geometry as jax_geometry
from softx_2020_200_tpu.fem import gmsh_io as jax_gmsh
from softx_2020_200_tpu.fem import mesh as jax_mesh
from softx_2020_200_tpu.fem import transfer as jax_transfer
from softx_2020_200_tpu.fem.dof import FESpace as JaxFESpace
from softx_2020_200_tpu.solvers import kelly as jax_kelly
from softx_2020_200_tpu_torch.fem import constraints, forest, gmsh_io
from softx_2020_200_tpu_torch.fem import host_geometry, mesh, transfer
from softx_2020_200_tpu_torch.fem.dof import FESpace
from softx_2020_200_tpu_torch.solvers import kelly
from tests.test_forest_rotated import rotated_two_cell_mesh
from tests.test_gmsh_and_cylinder import (MSH22, _msh41_quad4,
                                          _msh41_quad9_annulus)

torch.set_num_threads(1)


def _base(m, case):
    """The base mesh of ``case`` from the mesh module ``m`` (either
    package's)."""
    if case == "square":
        return m.hyper_cube(0.0, 1.0, colorize=True, dim=2)
    if case == "cube":
        return m.hyper_cube(0.0, 1.0, colorize=True, dim=3)
    if case == "periodic":
        b = m.hyper_cube(0.0, 1.0, colorize=True, dim=2)
        b.periodic.append((0, 1, 0))
        return b
    if case == "cylinder":
        return m.channel_with_cylinder()
    ref = rotated_two_cell_mesh()
    return m.Mesh(dim=2, vertices=ref.vertices.copy(),
                  cells=ref.cells.copy(),
                  boundary_faces=ref.boundary_faces.copy())


CASES = ("square", "cube", "periodic", "cylinder", "rotated")


def _forests(case, seed=0, cycles=2):
    """The same forest in both packages: uniform refinement of the base
    mesh, then ``cycles`` rounds of seeded refine, coarsen and balance.
    Returns (JAX forest, port forest)."""
    fa = jax_forest.Forest(_base(jax_mesh, case))
    fb = forest.Forest(_base(mesh, case))
    n0 = 1 if case in ("cube", "cylinder") else 2
    for f in (fa, fb):
        for _ in range(n0):
            f.refine(np.column_stack(f._leaf_arrays_only()))
    rng = np.random.default_rng(seed)
    for _ in range(cycles):
        rows = np.column_stack(fa._leaf_arrays_only())
        assert np.array_equal(rows, np.column_stack(fb._leaf_arrays_only()))
        ref = rows[rng.random(len(rows)) < 0.15]
        coa = rows[rng.random(len(rows)) < 0.3]
        if case == "periodic":
            # cells along the seam on its x- side only: the DoF numbering
            # fuses a periodic seam whose one side nests in the other
            ref = rows[(rows[:, 2] == 0) & (rng.random(len(rows)) < 0.5)]
            coa = rows[:0]
        for f in (fa, fb):
            f.coarsen(coa)
            f.refine(ref)
            f.balance()
    return fa, fb


def _nc_tuple(faces):
    return [tuple(dataclasses.astuple(f)) for f in faces]


@pytest.mark.parametrize("case", CASES)
def test_forest_and_mesh_match_jax(case):
    """Refine, coarsen and balance give equal leaf sets; ``build_mesh``
    equal vertices, cells, boundary faces, element map and
    non-conforming faces (and there are some)."""
    fa, fb = _forests(case)
    assert fb.leaves == fa.leaves
    ma, ea, ncfa = fa.build_mesh()
    mb, eb, ncfb = fb.build_mesh()
    np.testing.assert_array_equal(mb.vertices, ma.vertices)
    np.testing.assert_array_equal(mb.cells, ma.cells)
    np.testing.assert_array_equal(mb.boundary_faces, ma.boundary_faces)
    assert eb == ea
    assert _nc_tuple(ncfb) == _nc_tuple(ncfa) and ncfa
    assert mb.structured_shape is None


def _spaces(case, degree):
    fa, fb = _forests(case)
    ma, ea, ncfa = fa.build_mesh()
    mb, eb, ncfb = fb.build_mesh()
    return (fa, ma, ea, ncfa, JaxFESpace(ma, degree)), \
        (fb, mb, eb, ncfb, FESpace(mb, degree))


@pytest.mark.parametrize("case,degree", [
    ("square", 1), ("square", 2), ("cube", 1), ("cube", 2),
    ("cylinder", 1), ("cylinder", 2), ("rotated", 2), ("periodic", 1)])
def test_hanging_constraints_on_forests_match_jax(case, degree):
    """Rows, masters and weights of the hanging constraints, and both
    applications, on forest meshes."""
    (_, _, _, ncf, sa), (_, _, _, _, sb) = _spaces(case, degree)
    ha = jax_constraints.build_hanging_constraints(sa, ncf)
    hb = constraints.build_hanging_constraints(sb, ncf)
    assert hb.n == ha.n > 0
    np.testing.assert_array_equal(hb.ids.numpy(), np.asarray(ha.ids))
    np.testing.assert_array_equal(hb.masters.numpy(), np.asarray(ha.masters))
    np.testing.assert_allclose(hb.weights.numpy(), np.asarray(ha.weights),
                               rtol=0, atol=1e-14)
    rng = np.random.default_rng(degree)
    u = rng.standard_normal((sa.n_nodes, sa.dim + 1))
    for fa_, fb_ in ((ha.distribute, hb.distribute),
                     (ha.distribute_transpose, hb.distribute_transpose)):
        np.testing.assert_allclose(fb_(torch.from_numpy(u)).numpy(),
                                   np.asarray(fa_(jnp.asarray(u))),
                                   rtol=0, atol=1e-13)


@pytest.mark.parametrize("case,degree", [
    ("square", 1), ("square", 2), ("cube", 1), ("cylinder", 1),
    ("rotated", 2), ("periodic", 2)])
def test_kelly_matches_jax(case, degree):
    """The Kelly indicators of a seeded field on a forest mesh with
    hanging faces within 1e-12 relative, and equal refine and coarsen
    flags in both fraction modes."""
    (_, _, _, ncf, sa), (_, _, _, _, sb) = _spaces(case, degree)
    rng = np.random.default_rng(7)
    u = rng.standard_normal((sa.n_nodes, sa.dim + 1))
    ea = jax_kelly.kelly_estimate(
        SimpleNamespace(space=sa, dim=sa.dim,
                        xe=jnp.asarray(sa.element_coords()),
                        elem_nodes=sa.elem_nodes),
        jnp.asarray(u), nc_faces=ncf)
    eb = kelly.kelly_estimate(
        SimpleNamespace(space=sb, dim=sb.dim, xe=sb.element_coords(),
                        elem_nodes=sb.elem_nodes), u, nc_faces=ncf)
    np.testing.assert_allclose(eb, ea, rtol=1e-12, atol=0)
    for kind in ("number", "fraction"):
        fa = jax_kelly.flag_cells(ea, fraction_type=kind,
                                  refine_fraction=0.2, coarsen_fraction=0.1)
        fb = kelly.flag_cells(eb, fraction_type=kind, refine_fraction=0.2,
                              coarsen_fraction=0.1)
        for a, b in zip(fa, fb):
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("case,degree", [("square", 1), ("square", 2),
                                         ("cube", 1), ("periodic", 2)])
def test_transfer_is_exact_and_matches_jax(case, degree):
    """A field in the FE space (a polynomial of the space's degree on an
    affine forest) moves across refinement and coarsening exactly, and
    the port's transfer equals the JAX package's."""
    (fa, _, ea, _, sa), (fb, _, eb, _, sb) = _spaces(case, degree)

    def field(x):
        cols = [x[:, 0] ** degree * (1 + x[:, 1]), x[:, 1] - 2 * x[:, 0],
                x[:, 0] * x[:, 1] ** degree]
        if case == "periodic":   # periodic in x: no x dependence
            cols = [x[:, 1] ** degree, 1 + x[:, 1], 3 - x[:, 1]]
        return np.stack(cols[:sa.dim] + [x[:, -1] + 1.0], axis=1)

    snap_a = jax_forest.Forest.__new__(jax_forest.Forest)
    snap_a.__dict__.update(base=fa.base, dim=fa.dim, _adjacency=fa._adjacency,
                           leaves=[set(s) for s in fa.leaves])
    snap_b = forest.Forest.__new__(forest.Forest)
    snap_b.__dict__.update(base=fb.base, dim=fb.dim, _adjacency=fb._adjacency,
                           leaves=[set(s) for s in fb.leaves])
    rng = np.random.default_rng(3)
    rows = np.column_stack(fa._leaf_arrays_only())
    ref, coa = rows[rng.random(len(rows)) < 0.3], rows[::3]
    for f in (fa, fb):
        f.coarsen(coa)
        f.refine(ref)
        f.balance()
    ma, ea2, _ = fa.build_mesh()
    mb, eb2, _ = fb.build_mesh()
    na, nb = JaxFESpace(ma, degree), FESpace(mb, degree)
    u = field(sa.nodes)
    (want,) = jax_transfer.transfer_solution(sa, snap_a, ea, na, fa, ea2,
                                             [jnp.asarray(u)])
    (got,) = transfer.transfer_solution(sb, snap_b, eb, nb, fb, eb2,
                                        [torch.from_numpy(u)])
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got.numpy(), field(nb.nodes), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("name,dim", [("msh22_quad4", 2), ("msh41_quad4", 2),
                                      ("msh41_quad9", 2)])
def test_gmsh_reader_matches_jax(name, dim, tmp_path):
    """MSH 2.2 and 4.1, quad and quad9 (curved), written here: equal
    meshes, boundary ids and second-order geometry in both packages."""
    text = {"msh22_quad4": MSH22, "msh41_quad4": _msh41_quad4(),
            "msh41_quad9": _msh41_quad9_annulus()}[name]
    path = tmp_path / f"{name}.msh"
    path.write_text(text)
    ma = jax_gmsh.read_msh(str(path), dim)
    mb = gmsh_io.read_msh(str(path), dim)
    for key in ("vertices", "cells", "boundary_faces"):
        np.testing.assert_array_equal(getattr(mb, key), getattr(ma, key))
    assert (mb.geom_nodes is None) == (ma.geom_nodes is None)
    if ma.geom_nodes is not None:
        np.testing.assert_array_equal(mb.geom_nodes, ma.geom_nodes)
        fa, fb = ma.refine_uniform(1), mb.refine_uniform(1)
        np.testing.assert_array_equal(fb.geom_nodes, fa.geom_nodes)


@pytest.mark.parametrize("dim", [2, 3])
def test_host_geometry_matches_jax_numpy_path(dim):
    """The NumPy geometry Kelly uses, against the JAX package's
    functions called with ``xp=np``, on seeded Jacobians."""
    rng = np.random.default_rng(dim)
    J = rng.standard_normal((6, 5, dim, dim)) + 3 * np.eye(dim)
    for got, want in zip(host_geometry.det_and_inv(J, xp=np),
                         jax_geometry.det_and_inv(J, xp=np)):
        np.testing.assert_array_equal(got, want)
    for face in range(2 * dim):
        for got, want in zip(
                host_geometry.face_measure_and_normal(J, face, xp=np),
                jax_geometry.face_measure_and_normal(J, face, xp=np)):
            np.testing.assert_array_equal(got, want)
