"""The PyTorch package's structured lattice layout against the JAX
package's ``StructuredLayout``, on the same meshes and float64 inputs made
with numpy: the element permutation, the element coordinates, the
gathered rows (the JAX package's node-major list order, n*c + comp), the
assembled scatter, and gather/scatter adjointness.  The port reads the
windows directly where the JAX package decomposes them by residue for
degree >= 2, so equal outputs hold the semantics, Q2 and Q3, periodic or
not.  Exact up to summation order (1e-13 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softx_2020_200_tpu.fem import mesh as jax_mesh
from softx_2020_200_tpu.fem.dof import FESpace as JaxFESpace
from softx_2020_200_tpu.ops.structured import \
    StructuredLayout as JaxStructuredLayout
from softx_2020_200_tpu_torch.fem import mesh as port_mesh
from softx_2020_200_tpu_torch.fem.dof import FESpace
from softx_2020_200_tpu_torch.ops.structured import StructuredLayout

torch.set_num_threads(1)

CASES = [(2, 1, ()), (2, 2, (0,)), (2, 2, (0, 1)), (2, 3, (1,)),
         (3, 2, (0, 2))]


def _layouts(dim, degree, paxes):
    cells = [4, 3, 2][:dim]

    def space(m, fes):
        mesh = m.subdivided_hyper_rectangle([0.0] * dim, [1.0, 0.8, 1.2][:dim],
                                            cells, colorize=True, dim=dim)
        mesh.periodic += [(2 * a, 2 * a + 1, a) for a in paxes]
        return fes(mesh, degree)

    sa = space(jax_mesh, JaxFESpace)
    sb = space(port_mesh, FESpace)
    return JaxStructuredLayout(sa), StructuredLayout(sb), sb


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dim,degree,paxes", CASES)
def test_layout_matches_jax(dim, degree, paxes):
    ja, po, space = _layouts(dim, degree, paxes)
    assert po.m == ja.m and po.E == ja.E and po.nn == ja.nn
    np.testing.assert_array_equal(po.elem_perm, ja.elem_perm)
    np.testing.assert_array_equal(po.elem_coords_grid_order(),
                                  ja.elem_coords_grid_order())

    c = dim + 1
    rng = np.random.default_rng(dim * 10 + degree)
    u = rng.standard_normal((space.n_nodes, c))
    rows = rng.standard_normal((c, po.nn, po.E))

    # gather: the JAX list is node-major (n*c + comp)
    g_ref = np.stack([np.asarray(r) for r in
                      ja.gather_rows_list(jnp.asarray(u))])
    g = po.gather(torch.as_tensor(u))                    # [c, nn, E]
    np.testing.assert_array_equal(
        g.permute(1, 0, 2).reshape(-1, po.E).numpy(), g_ref)

    s_ref = ja.scatter_rows_list(
        [jnp.asarray(rows[i, n]) for n in range(po.nn) for i in range(c)], c)
    s = po.scatter(torch.as_tensor(rows))
    assert s.shape == (space.n_nodes, c)
    assert _rel(s, s_ref) < 1e-13


@pytest.mark.parametrize("dim,degree,paxes", CASES)
def test_gather_scatter_adjoint(dim, degree, paxes):
    """<gather(u), r> == <u, scatter(r)>."""
    _, po, space = _layouts(dim, degree, paxes)
    c = dim + 1
    rng = np.random.default_rng(7)
    u = torch.as_tensor(rng.standard_normal((space.n_nodes, c)))
    r = torch.as_tensor(rng.standard_normal((c, po.nn, po.E)))
    lhs = float(torch.sum(po.gather(u) * r))
    rhs = float(torch.sum(u * po.scatter(r)))
    assert abs(lhs - rhs) < 1e-12 * max(1.0, abs(lhs))


def test_layout_rejects_unstructured_mesh():
    mesh = port_mesh.hyper_shell([0.0, 0.0], 0.25, 1.0, 8)
    with pytest.raises(ValueError, match="not a structured block"):
        StructuredLayout(FESpace(mesh, 1))
