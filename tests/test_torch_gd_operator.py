"""The PyTorch package's grad-div Taylor-Hood operator against the JAX
package's, on the CPU in float64 with the same inputs made with numpy.

Both of the port's paths are held against the JAX ``GDOperator`` (the
SoA einsum path, which is what the JAX package runs off the TPU): the
lattice path (strided layouts of both spaces + B3's plain version) on a
box lattice, and the SoA path on the same mesh with its lattice shape
dropped.  Checked: the residual, the Jacobian action against
``jax.jvp``, the velocity node blocks (closed form in the port, jvp
probes in the JAX package), the lumped pressure mass, L2 errors and the
CFL number; and that a JAX GD state moves across
(``interop.state_from_numpy``) with its residual.

Tolerance: 1e-12 of the max-abs scale (float64; the two packages sum in
different orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softx_2020_200_tpu.core.expressions import \
    VectorExpression as JaxExpression
from softx_2020_200_tpu.fem import mesh as jax_mesh
from softx_2020_200_tpu.solvers.gd import GDOperator as JaxGDOperator
from softx_2020_200_tpu_torch.core.expressions import VectorExpression
from softx_2020_200_tpu_torch.fem import mesh as port_mesh
from softx_2020_200_tpu_torch.interop import state_from_numpy
from softx_2020_200_tpu_torch.ops.lattice_gd_kernel import LatticeGDKernel
from softx_2020_200_tpu_torch.solvers.gd import GDOperator

torch.set_num_threads(1)

RTOL = 1e-12
NU, GAMMA = 0.05, 0.8
CPU = dict(device="cpu", dtype=torch.float64)
EXACT = {2: "sin(x)*y; x*y*y; cos(x+y)",
         3: "sin(x)*y; x*z; y*y*z; cos(x+y-z)"}


def _mesh(m, dim, periodic):
    mesh = m.subdivided_hyper_rectangle([0.0] * dim, [1.0, 0.7, 1.3][:dim],
                                        [3, 4, 2][:dim], colorize=True,
                                        dim=dim)
    if periodic:
        mesh.periodic.append((0, 1, 0))
    return mesh


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _pair(dim, periodic, lattice):
    ja = JaxGDOperator(_mesh(jax_mesh, dim, periodic), degree_pressure=1,
                       nu=NU, gamma=GAMMA, dtype=jnp.float64)
    mesh = _mesh(port_mesh, dim, periodic)
    if not lattice:
        mesh = dataclasses.replace(mesh, structured_shape=None)
    po = GDOperator(mesh, degree_pressure=1, nu=NU, gamma=GAMMA, **CPU)
    assert (po.layout_v is not None) == lattice
    assert isinstance(getattr(po, "kernel", None), LatticeGDKernel) == lattice
    np.testing.assert_array_equal(po.space_v.elem_nodes,
                                  ja.space_v.elem_nodes)
    np.testing.assert_array_equal(po.space_p.elem_nodes,
                                  ja.space_p.elem_nodes)
    return ja, po


def _inputs(op, dim, seed):
    rng = np.random.default_rng(seed)
    return dict(x=rng.standard_normal(op.n_dofs) * 0.3,
                dx=rng.standard_normal(op.n_dofs),
                vprev=rng.standard_normal((op.Nv, dim)) * 0.1,
                fq=rng.standard_normal((op.space_v.n_elements, op.n_q,
                                        dim)) * 0.05)


CASES = [pytest.param(d, p, lat, id=f"{d}d-{'periodic' if p else 'box'}-"
                      f"{'lattice' if lat else 'soa'}")
         for d in (2, 3) for p in (False, True) for lat in (True, False)]


@pytest.mark.parametrize("dim,periodic,lattice", CASES)
def test_operator_matches_jax(dim, periodic, lattice):
    ja, po = _pair(dim, periodic, lattice)
    z = _inputs(po, dim, seed=dim + 2 * periodic)
    a0 = 1.7
    ja_args = (jnp.asarray(z["vprev"]), jnp.asarray(z["fq"]), a0, 0.0)
    t = {k: torch.as_tensor(v) for k, v in z.items()}
    po_args = (t["vprev"], t["fq"], a0)

    r_ref = ja.residual_free(jnp.asarray(z["x"]), *ja_args)
    assert _rel(po.residual_free(t["x"], *po_args), r_ref) < RTOL

    dr_ref = jax.jvp(lambda w: ja.residual_free(w, *ja_args),
                     (jnp.asarray(z["x"]),), (jnp.asarray(z["dx"]),))[1]
    state = po.linearize(t["x"], *po_args)
    assert _rel(po.jvp(state, t["dx"]), dr_ref) < RTOL

    nb_ref = ja.velocity_node_blocks(jnp.asarray(z["x"]), *ja_args)
    assert _rel(po.velocity_node_blocks(t["x"], a0), nb_ref) < RTOL

    assert _rel(po.pressure_lumped_mass(), ja.pressure_lumped_mass()) < RTOL
    ev, ep = ja.l2_errors(jnp.asarray(z["x"]), JaxExpression(EXACT[dim]),
                          0.3)
    gv, gp = po.l2_errors(t["x"], VectorExpression(EXACT[dim]), 0.3)
    assert float(gv) == pytest.approx(float(ev), rel=RTOL)
    assert float(gp) == pytest.approx(float(ep), rel=RTOL)
    assert float(po.cfl(t["x"], 0.1)) == pytest.approx(
        float(ja.cfl(jnp.asarray(z["x"]), 0.1)), rel=RTOL)


def test_jax_state_moves_across():
    """A JAX GD flat state and its history [Nv*d + Np] become the port's
    tensors unchanged: both packages number the velocity and pressure
    nodes the same way, so the residual at the moved state is the JAX
    residual."""
    ja, po = _pair(2, True, True)
    z = _inputs(po, 2, seed=5)
    x_jax = jnp.asarray(z["x"])
    prev_jax = [x_jax * 0.5, x_jax * 0.25]
    x, prev = state_from_numpy(np.asarray(x_jax),
                               [np.asarray(p) for p in prev_jax], **CPU)
    assert x.shape == (po.n_dofs,) and len(prev) == 2
    np.testing.assert_array_equal(prev[1].numpy(), np.asarray(prev_jax[1]))
    vprev, fq = torch.as_tensor(z["vprev"]), torch.as_tensor(z["fq"])
    r_ref = ja.residual_free(x_jax, jnp.asarray(z["vprev"]),
                             jnp.asarray(z["fq"]), 2.0, 0.0)
    assert _rel(po.residual_free(x, vprev, fq, 2.0), r_ref) < RTOL


def test_non_translate_mesh_takes_the_soa_path():
    """A box lattice with one moved interior vertex keeps its structured
    shape but is no lattice of translates: the operator takes the SoA
    path, and still matches the JAX package."""
    meshes = [_mesh(m, 2, False) for m in (jax_mesh, port_mesh)]
    for mesh in meshes:
        inner = np.all((mesh.vertices > 1e-9)
                       & (mesh.vertices < [1 - 1e-9, 0.7 - 1e-9]), axis=1)
        mesh.vertices[np.flatnonzero(inner)[0]] += [0.03, -0.02]
    ja = JaxGDOperator(meshes[0], nu=NU, gamma=GAMMA, dtype=jnp.float64)
    po = GDOperator(meshes[1], nu=NU, gamma=GAMMA, **CPU)
    assert meshes[1].structured_shape is not None and po.layout_v is None
    z = _inputs(po, 2, seed=11)
    r_ref = ja.residual_free(jnp.asarray(z["x"]), jnp.asarray(z["vprev"]),
                             jnp.asarray(z["fq"]), 1.0, 0.0)
    t = {k: torch.as_tensor(v) for k, v in z.items()}
    assert _rel(po.residual_free(t["x"], t["vprev"], t["fq"], 1.0),
                r_ref) < RTOL
