"""The plain version of the CUDA GD lattice kernel (B3's port) against the
TPU kernel B3 (``PallasLatticeGD`` in interpret mode), on the same
float64 rows made with numpy: the primal residual and the exact tangent,
2D and 3D, periodic and not, in the mixed component-major row layout.

Tolerance: rtol 1e-10, atol 1e-12, the JAX package's own bar for B3
against its einsum path (``tests/test_pallas_lattice_gd.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softx_2020_200_tpu.fem import mesh as jax_mesh
from softx_2020_200_tpu.fem.dof import FESpace as JaxFESpace
from softx_2020_200_tpu.ops.pallas_lattice_gd import (PallasLatticeGD,
                                                      _gd_affine_tables)
from softx_2020_200_tpu_torch.fem import mesh as port_mesh
from softx_2020_200_tpu_torch.fem.dof import FESpace
from softx_2020_200_tpu_torch.ops.lattice_gd_kernel import (
    LatticeGDKernel, gd_affine_tables)
from softx_2020_200_tpu_torch.ops.structured import StructuredLayout

torch.set_num_threads(1)

NU, GAMMA = 0.01, 0.7
CPU = dict(device="cpu", dtype=torch.float64)


def _mesh(m, dim, n, periodic):
    mesh = m.subdivided_hyper_rectangle([0.0] * dim, [1.0, 0.7, 1.3][:dim],
                                        [n] * dim, colorize=True, dim=dim)
    if periodic:
        mesh.periodic += [(2 * a, 2 * a + 1, a) for a in range(dim)]
    return mesh


def _kernel_pair(dim, n, periodic):
    """(JAX B3 in interpret mode, the port's wrapper on the CPU), both
    built from the same lattice."""
    sv = FESpace(_mesh(port_mesh, dim, n, periodic), 2)
    xe = StructuredLayout(sv).elem_coords_grid_order()
    ma = _mesh(jax_mesh, dim, n, periodic)
    pg = PallasLatticeGD(JaxFESpace(ma, 2), JaxFESpace(ma, 1), NU, GAMMA,
                         xe, n_q1d=3, dtype=jnp.float64, interpret=True)
    _, w, Bv, Gv, _ = sv.basis.quadrature(3)
    _, _, Bp, _, _ = FESpace(sv.mesh, 1).basis.quadrature(3)
    k = LatticeGDKernel(dim=dim, degree_pressure=1, Bv=Bv, Gv=Gv, Bp=Bp,
                        w=w, xe0=xe[0], nu=NU, gamma=GAMMA, **CPU)
    return pg, k, sv.n_elements


@pytest.mark.parametrize("periodic", [False, True],
                         ids=["bounded", "periodic"])
@pytest.mark.parametrize("dim,n", [(2, 5), (3, 3)])
def test_plain_gd_kernel_matches_tpu_kernel(dim, n, periodic):
    pg, k, E = _kernel_pair(dim, n, periodic)
    rs, nv, nq = k.rows, dim * k.nnv, k.nq
    rng = np.random.default_rng(7)
    ue = rng.standard_normal((rs, E)) * 0.3
    due = rng.standard_normal((rs, E))
    vpe = rng.standard_normal((nv, E)) * 0.1
    fq = rng.standard_normal((dim * nq, E)) * 0.05
    a0 = 1.7

    def pad(a):
        return jnp.asarray(np.pad(a, ((0, 0), (0, pg.Ep - E))))

    ue2, due2, vpe2, fq2 = (pad(a) for a in (ue, due, vpe, fq))
    r_ref = np.asarray(pg.residual_rows(ue2, vpe2, fq2, a0))[:, :E]
    dr_ref = np.asarray(jax.jvp(
        lambda x: pg.residual_rows(x, vpe2, fq2, a0), (ue2,),
        (due2,))[1])[:, :E]

    tue, tdue, tvpe, tfq = (torch.as_tensor(a) for a in (ue, due, vpe, fq))
    np.testing.assert_allclose(k.residual(tue, tvpe, tfq, a0).numpy(),
                               r_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(k.tangent(tue, tdue, a0).numpy(), dr_ref,
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dim", [2, 3])
def test_gd_affine_tables_match_jax(dim):
    sv = FESpace(_mesh(port_mesh, dim, 2, False), 2)
    _, w, Bv, Gv, _ = sv.basis.quadrature(3)
    _, _, Bp, _, _ = FESpace(sv.mesh, 1).basis.quadrature(3)
    args = (dim, Bv, Gv, Bp, w, sv.element_coords()[1])
    for got, want in zip(gd_affine_tables(*args), _gd_affine_tables(*args)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    xe = sv.element_coords()[1].copy()
    xe[-1] += 0.05                    # a corner moved: not affine
    with pytest.raises(ValueError, match="not affine"):
        gd_affine_tables(dim, Bv, Gv, Bp, w, xe)


def test_wrapper_refuses_other_devices():
    _, k, _ = _kernel_pair(2, 2, False)
    ue = torch.empty((k.rows, 4), device="meta")
    with pytest.raises(ValueError, match="no GD lattice kernel"):
        k.residual(ue, ue[:18], ue[:18], 1.0)
    with pytest.raises(ValueError, match="no GD lattice kernel"):
        k.tangent(ue, ue, 1.0)
