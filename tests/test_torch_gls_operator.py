"""The PyTorch GLS operator and its element kernel against the JAX
package, on the same float64 inputs made with numpy.

- ``GLSOperator`` (residual, exact and frozen-tau tangents, node blocks,
  CFL) against the JAX ``GLSOperator`` on its XLA path;
- the plain version of the CUDA element kernel against the TPU kernel B1
  (``PallasGLS`` in interpret mode, float64), primal and frozen-tau
  tangent;
- the per-element kernel against the JAX one.

Tolerance: 1e-12 of the max-abs scale (float64; the two packages sum in
different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softx_2020_200_tpu.fem import mesh as jax_mesh
from softx_2020_200_tpu.fem.dof import FESpace as JaxFESpace
from softx_2020_200_tpu.ops.operators import gather_elements
from softx_2020_200_tpu.ops.pallas_gls import PallasGLS
from softx_2020_200_tpu.solvers import gls as jax_gls
from softx_2020_200_tpu_torch.fem import mesh as port_mesh
from softx_2020_200_tpu_torch.fem.dof import FESpace
from softx_2020_200_tpu_torch.ops.batched_kernel import tangent_batched
from softx_2020_200_tpu_torch.solvers.gls import (GLSOperator, StabFlags,
                                                  make_element_kernel)

torch.set_num_threads(1)

RTOL = 1e-12
NU = 0.05
A0, SDT = 2.0, 4.0


def _mesh(m, dim, geometry):
    if geometry == "box":
        return m.subdivided_hyper_rectangle([0.0] * dim, [1.0] * dim,
                                            [3, 2, 2][:dim], colorize=True,
                                            dim=dim)
    if dim == 2:
        return m.hyper_shell([0.0, 0.0], 0.25, 1.0, 6)
    return m.hyper_shell([0.0, 0.0, 0.0], 0.5, 1.0)


def _setup(dim, degree, geometry, seed=5):
    sa = JaxFESpace(_mesh(jax_mesh, dim, geometry), degree)
    sb = FESpace(_mesh(port_mesh, dim, geometry), degree)
    rng = np.random.default_rng(seed)
    N, c, E = sa.n_nodes, dim + 1, sa.n_elements
    nq = (degree + 1) ** dim
    data = dict(u=rng.standard_normal((N, c)) * 0.3,
                v=rng.standard_normal((N, c)),
                prev=rng.standard_normal((N, dim)) * 0.2,
                fq=rng.standard_normal((E, nq, dim)),
                mask=rng.random((N, c)) < 0.2)
    return sa, sb, data


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _t(x):
    return torch.as_tensor(np.array(x))


CASES = [(d, k, g) for d in (2, 3) for k in (1, 2) for g in ("box", "shell")]


@pytest.mark.parametrize("dim,degree,geometry", CASES)
def test_operator_matches_jax(dim, degree, geometry):
    sa, sb, x = _setup(dim, degree, geometry)
    ja = jax_gls.GLSOperator(sa, nu=NU, dtype=jnp.float64)
    ja_fr = jax_gls.GLSOperator(sa, nu=NU, dtype=jnp.float64,
                                stab=jax_gls.StabFlags(frozen_tau=True))
    op = GLSOperator(sb, nu=NU)
    op_fr = GLSOperator(sb, nu=NU, stab=StabFlags(frozen_tau=True))
    u, v, prev, fq = (jnp.asarray(x[k]) for k in ("u", "v", "prev", "fq"))
    tu, tv, tprev, tfq = (_t(x[k]) for k in ("u", "v", "prev", "fq"))

    # (the JAX side is jitted: its op-by-op dispatch compiles each
    # primitive separately, which costs more than the whole graph)

    # residual
    r_ref = jax.jit(lambda w: ja.residual_free(w, prev, fq, A0, SDT))(u)
    r = op.residual_free(tu, tprev, tfq, A0, SDT)
    assert _rel(r, r_ref) < RTOL
    mask = x["mask"]
    rc_ref = jax.jit(lambda w: ja.residual(w, jnp.asarray(mask), prev, fq,
                                           A0, SDT))(u)
    rc = op.residual(tu, torch.as_tensor(mask), tprev, tfq, A0, SDT)
    assert _rel(rc, rc_ref) < RTOL

    # exact and frozen-tau tangents through linearize/jvp
    for ref_op, port_op in ((ja, op), (ja_fr, op_fr)):
        d_ref = jax.jit(lambda w, dw: jax.jvp(
            lambda y: ref_op.residual_free(y, prev, fq, A0, SDT),
            (w,), (dw,))[1])(u, v)
        state = port_op.linearize(tu, tprev, tfq, A0, SDT)
        assert _rel(port_op.jvp(state, tv), d_ref) < RTOL

    # node blocks (exact tau, Dirichlet rows/cols zeroed)
    b_ref = jax.jit(lambda w: ja.node_blocks(w, jnp.asarray(mask), prev,
                                             fq, A0, SDT))(u)
    b = op.node_blocks(tu, torch.as_tensor(mask), tprev, tfq, A0, SDT)
    assert _rel(b, b_ref) < RTOL

    cfl_ref = float(jax.jit(lambda w: ja.cfl(w, 0.1))(u))
    assert abs(float(op.cfl(tu, 0.1)) / cfl_ref - 1) < RTOL


# the TPU kernel in interpret mode unrolls nn*nq terms per tile: one
# geometry per (dim, degree), and only 2D Q1 (about 10 s) in the fast
# tier; 2D Q2 traces for about 30 s and 3D for many minutes, as the JAX
# package's own 3D interpret test (tests/test_pallas_kernel.py) is slow.
# With LSIC, B1's tangent freezes the LSIC coefficient with tau, and so
# does the plain version under frozen tau.
SLOW = pytest.mark.slow


@pytest.mark.parametrize("dim,degree,geometry,lsic", [
    pytest.param(2, 1, "shell", False, id="2-1-shell"),
    pytest.param(2, 1, "shell", True, id="2-1-shell-lsic"),
    pytest.param(2, 2, "box", False, id="2-2-box", marks=SLOW),
    pytest.param(3, 1, "shell", False, id="3-1-shell", marks=SLOW),
    pytest.param(3, 1, "shell", True, id="3-1-shell-lsic", marks=SLOW),
    pytest.param(3, 2, "box", False, id="3-2-box", marks=SLOW)])
def test_plain_kernel_matches_tpu_kernel(dim, degree, geometry, lsic):
    sa, sb, x = _setup(dim, degree, geometry, seed=9)
    pg = PallasGLS(sa, nu=NU, lsic=lsic, dtype=jnp.float64, interpret=True)
    op = GLSOperator(sb, nu=NU, stab=StabFlags(lsic=lsic))
    en = jnp.asarray(sa.elem_nodes)
    ue = gather_elements(jnp.asarray(x["u"]), en)
    due = gather_elements(jnp.asarray(x["v"]), en)
    upe = gather_elements(jnp.asarray(x["prev"]), en)
    fq = jnp.asarray(x["fq"])
    ue2, up2, fq2 = pg.to_rows(ue), pg.to_rows(upe), pg.to_rows(fq)
    r_pg = pg.from_rows(pg.residual_rows(ue2, up2, fq2, A0, SDT))
    dr_pg = pg.from_rows(jax.jvp(
        lambda w: pg.residual_rows(w, up2, fq2, A0, SDT),
        (ue2,), (pg.to_rows(due),))[1])

    def soa(a):        # [E, k, l] -> [k, l, E]
        return _t(np.asarray(a)).permute(1, 2, 0).contiguous()

    E = sa.n_elements
    frozen = op.kernel.plain(StabFlags(lsic=lsic, frozen_tau=True))
    args = (op.xe_soa, soa(upe), soa(fq), op.h, A0, SDT)
    r = op.kernel.plain()(soa(ue), *args)
    dr = tangent_batched(frozen, soa(ue), soa(due), *args)
    assert _rel(r.permute(2, 0, 1).reshape(E, -1), r_pg) < RTOL
    assert _rel(dr.permute(2, 0, 1).reshape(E, -1), dr_pg) < RTOL


@pytest.mark.parametrize("dim,degree", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_element_kernel_matches_jax(dim, degree):
    sa, sb, x = _setup(dim, degree, "shell", seed=2)
    _, wts, B, G, H = sa.basis.quadrature(degree + 1)
    kj = jax_gls.make_element_kernel(
        dim=dim, degree=degree, B=jnp.asarray(B), G=jnp.asarray(G),
        H=jnp.asarray(H), w=jnp.asarray(wts), nu=NU,
        stab=jax_gls.StabFlags(), dtype=jnp.float64)
    kt = make_element_kernel(dim=dim, degree=degree, B=_t(B), G=_t(G),
                             H=_t(H), w=_t(wts), nu=NU, stab=StabFlags())
    en = sa.elem_nodes
    ue, upe = x["u"][en], x["prev"][en]
    xe = sa.element_coords()
    r_ref = jax.vmap(kj, in_axes=(0, 0, 0, 0, None, None))(
        jnp.asarray(ue), jnp.asarray(xe), jnp.asarray(upe),
        jnp.asarray(x["fq"]), A0, SDT)
    r = torch.func.vmap(kt, in_dims=(0, 0, 0, 0, None, None))(
        _t(ue), _t(xe), _t(upe), _t(x["fq"]), A0, SDT)
    assert _rel(r, r_ref) < RTOL
