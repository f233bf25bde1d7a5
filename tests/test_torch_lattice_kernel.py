"""The plain version of the CUDA lattice kernel (B2's port) against the
TPU kernel B2 and against the port's plain B1, on the same float64 inputs
made with numpy.

- ``LatticeGLSKernel`` on the CPU against ``PallasLatticeGLS`` in
  interpret mode: the primal residual, the frozen-tau tangent and the
  node-block probes, component-major rows, Q1/Q2 in 2D/3D (B2's body is
  a few dots, so even 3D Q2 interprets in seconds on these lattices);
- the operator's lattice path (strided layout + B2) against its B1 path
  (index gathers + B1) on the same periodic lattice, all four (d, k);
- ``affine_tables`` against the JAX package's ``_affine_tables``, and the
  rejection of meshes whose elements are not translates of one box.

Tolerance: 1e-12 of the max-abs scale (float64; the two packages sum in
different orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softx_2020_200_tpu.fem import mesh as jax_mesh
from softx_2020_200_tpu.fem.dof import FESpace as JaxFESpace
from softx_2020_200_tpu.ops.pallas_lattice import (PallasLatticeGLS,
                                                   _affine_tables)
from softx_2020_200_tpu_torch.fem import mesh as port_mesh
from softx_2020_200_tpu_torch.fem.dof import FESpace
from softx_2020_200_tpu_torch.ops.lattice_kernel import (
    LatticeGLSKernel, affine_tables, is_translate_lattice)
from softx_2020_200_tpu_torch.ops.structured import StructuredLayout
from softx_2020_200_tpu_torch.solvers.gls import GLSOperator, StabFlags

torch.set_num_threads(1)

RTOL = 1e-12
NU = 0.05
A0, SDT = 2.0, 4.0
CPU = dict(device="cpu", dtype=torch.float64)


def _mesh(m, dim, cells):
    return m.subdivided_hyper_rectangle([0.0] * dim, [1.0, 0.7, 1.3][:dim],
                                        list(cells), colorize=True, dim=dim)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


# (dim, degree, Gauss points per axis, LSIC); Q1 with 3 points is what
# the Q1 multigrid levels of a Q2 deck run
@pytest.mark.parametrize("dim,degree,q1d,lsic", [
    pytest.param(2, 1, 2, False, id="2-1"),
    pytest.param(2, 1, 2, True, id="2-1-lsic"),
    pytest.param(2, 2, 3, False, id="2-2"),
    pytest.param(3, 1, 2, True, id="3-1-lsic"),
    pytest.param(3, 2, 3, False, id="3-2"),
    pytest.param(3, 1, 3, False, id="3-1-q3")])
def test_plain_lattice_kernel_matches_tpu_kernel(dim, degree, q1d, lsic):
    cells = (3, 2, 2)[:dim]
    sa = JaxFESpace(_mesh(jax_mesh, dim, cells), degree)
    sb = FESpace(_mesh(port_mesh, dim, cells), degree)
    xe = StructuredLayout(sb).elem_coords_grid_order()
    pg = PallasLatticeGLS(sa, NU, xe, n_q1d=q1d, lsic=lsic,
                          dtype=jnp.float64, interpret=True)
    _, w, B, G, H = sb.basis.quadrature(q1d)
    k = LatticeGLSKernel(dim=dim, degree=degree, B=B, G=G, H=H, w=w,
                         xe0=xe[0], nu=NU,
                         stab=StabFlags(lsic=lsic, frozen_tau=True), **CPU)
    assert k.h == pytest.approx(pg.h, rel=1e-15)

    c, nn, nq, E = dim + 1, k.nn, k.nq, sb.n_elements
    rng = np.random.default_rng(9)
    ue = rng.standard_normal((c * nn, E)) * 0.3
    due = rng.standard_normal((c * nn, E))
    up = rng.standard_normal((dim * nn, E)) * 0.2
    fq = rng.standard_normal((dim * nq, E))

    def pad(a):
        return jnp.asarray(np.pad(a, ((0, 0), (0, pg.Ep - E))))

    ue2, due2, up2, fq2 = (pad(a) for a in (ue, due, up, fq))
    r_ref = pg.residual_rows(ue2, up2, fq2, A0, SDT)[:, :E]
    dr_ref = jax.jvp(lambda x: pg.residual_rows(x, up2, fq2, A0, SDT),
                     (ue2,), (due2,))[1][:, :E]
    nb_ref = pg.node_block_rows(ue2, up2, fq2, A0, SDT)[:, :, :E]

    t = (torch.as_tensor(a) for a in (ue, due, up, fq))
    tue, tdue, tup, tfq = t
    assert _rel(k.residual(tue, tup, tfq, A0, SDT), r_ref) < RTOL
    assert _rel(k.tangent(tue, tdue, tup, tfq, A0, SDT), dr_ref) < RTOL
    assert _rel(k.node_blocks(tue, tup, tfq, A0, SDT), nb_ref) < RTOL


@pytest.mark.parametrize("dim,degree", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_lattice_path_matches_element_path(dim, degree):
    """GLSOperator on a periodic lattice: the strided layout + B2 against
    index gathers + B1 (the same mesh with its lattice shape dropped),
    residual, exact and frozen tangents, and masked node blocks."""
    mesh = _mesh(port_mesh, dim, (3, 4, 2)[:dim])
    mesh.periodic.append((0, 1, 0))
    space = FESpace(mesh, degree)
    space_b1 = FESpace(dataclasses.replace(mesh, structured_shape=None),
                       degree)
    np.testing.assert_array_equal(space_b1.elem_nodes, space.elem_nodes)
    rng = np.random.default_rng(4)
    N, c, E = space.n_nodes, dim + 1, space.n_elements
    nq = (degree + 1) ** dim
    u, v = (torch.as_tensor(rng.standard_normal((N, c))) for _ in range(2))
    prev = torch.as_tensor(rng.standard_normal((N, dim)) * 0.2)
    fq = torch.as_tensor(rng.standard_normal((E, nq, dim)))
    mask = torch.as_tensor(rng.random((N, c)) < 0.2)
    for stab in (StabFlags(lsic=True), StabFlags(lsic=True,
                                                 frozen_tau=True)):
        lat = GLSOperator(space, NU, stab=stab, **CPU)
        ref = GLSOperator(space_b1, NU, stab=stab, **CPU)
        assert lat.layout is not None and ref.layout is None
        assert isinstance(lat.kernel, LatticeGLSKernel)
        assert _rel(lat.residual_free(u, prev, fq, A0, SDT),
                    ref.residual_free(u, prev, fq, A0, SDT)) < RTOL
        dl = lat.jvp(lat.linearize(u, prev, fq, A0, SDT), v)
        dr = ref.jvp(ref.linearize(u, prev, fq, A0, SDT), v)
        assert _rel(dl, dr) < RTOL
        assert _rel(lat.node_blocks(u, mask, prev, fq, A0, SDT),
                    ref.node_blocks(u, mask, prev, fq, A0, SDT)) < RTOL


@pytest.mark.parametrize("dim,degree", [(2, 1), (3, 2)])
def test_affine_tables_match_jax(dim, degree):
    space = FESpace(_mesh(port_mesh, dim, (2, 2, 2)[:dim]), degree)
    nq, nn = (degree + 1) ** dim, space.basis.n_nodes
    _, w, B, G, H = space.basis.quadrature(degree + 1)
    args = (dim, nn, nq, B, G, H.reshape(nq, nn, dim, dim), w,
            space.element_coords()[1], degree)
    for got, want in zip(affine_tables(*args), _affine_tables(*args)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_non_translate_meshes_take_the_element_path():
    """A lattice with a moved interior vertex is not a lattice of
    translates: the operator takes B1, ``is_translate_lattice`` says no,
    and ``affine_tables`` refuses a non-affine element."""
    mesh = _mesh(port_mesh, 2, (4, 4))
    inner = np.all((mesh.vertices > 1e-9)
                   & (mesh.vertices < [1 - 1e-9, 0.7 - 1e-9]), axis=1)
    mesh.vertices[np.flatnonzero(inner)[0]] += [0.03, -0.02]
    space = FESpace(mesh, 1)
    op = GLSOperator(space, NU, **CPU)
    assert op.layout is None
    _, w, B, G, H = space.basis.quadrature(2)
    xe = StructuredLayout(space).elem_coords_grid_order()
    assert not is_translate_lattice(xe, G)
    xs = space.element_coords()
    moved = [e for e in range(space.n_elements)
             if not is_translate_lattice(xs[[e, e]], G)]
    assert moved
    with pytest.raises(ValueError, match="not affine"):
        affine_tables(2, 4, 4, B, G, H.reshape(4, 4, 2, 2), w,
                      xs[moved[0]], 1)
    # a uniform lattice with one element scaled is no lattice either
    xe_ok = StructuredLayout(FESpace(_mesh(port_mesh, 2, (4, 4)), 1)) \
        .elem_coords_grid_order()
    assert is_translate_lattice(xe_ok, G)
    xe_ok[3] *= 1.5
    assert not is_translate_lattice(xe_ok, G)


def test_wrapper_refuses_other_devices():
    space = FESpace(_mesh(port_mesh, 2, (2, 2)), 1)
    _, w, B, G, H = space.basis.quadrature(2)
    k = LatticeGLSKernel(dim=2, degree=1, B=B, G=G, H=H, w=w,
                         xe0=space.element_coords()[0], nu=NU,
                         stab=StabFlags(), **CPU)
    ue = torch.empty((12, 4), device="meta")
    with pytest.raises(ValueError, match="no GLS lattice kernel"):
        k.residual(ue, ue[:8], ue[:8], A0, SDT)
