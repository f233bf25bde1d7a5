"""Element matrices and additive Schwarz of the PyTorch package against
the JAX package, on the CPU in float64, on the same inputs made with
numpy.

- ``GLSOperator.element_matrices`` against the JAX operator's (``jax.
  jacfwd`` of its element residual), on a box (the lattice path, B2's
  rows) and on a curved shell (B1's rows), Q1 and Q2, 2D and 3D, with
  exact and with frozen tau: within 1e-12 of scale.  The box lattices'
  element order differs from the space's, so the blocks must come back
  in the space's order to agree.
- The element matrices built from one-hot tangent probes of the plain
  frozen-tau kernel (what the CUDA kernels compute with nn*c tangent
  launches) against the JAX package's TPU kernels in interpret mode
  probed along the same one-hot directions: B1 on a shell, B2 on a
  lattice whose element order differs from the space's; within 1e-12.
- A Couette solve with ``preconditioner = additive_schwarz`` takes the
  JAX package's Newton iterations and its Krylov iterations within 1 per
  linear solve (the preconditioner's apply against the JAX package's is
  held in ``tests/test_torch_modules.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softx_2020_200_tpu.core.parameters import \
    SimulationParameters as JaxParameters
from softx_2020_200_tpu.fem import mesh as jax_mesh
from softx_2020_200_tpu.fem.dof import FESpace as JaxFESpace
from softx_2020_200_tpu.ops.operators import gather_elements
from softx_2020_200_tpu.solvers import gls as jax_gls
from softx_2020_200_tpu.solvers.base import \
    GLSNavierStokesSolver as JaxSolver
from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
from softx_2020_200_tpu_torch.fem import mesh as port_mesh
from softx_2020_200_tpu_torch.fem.dof import FESpace
from softx_2020_200_tpu_torch.solvers.base import GLSNavierStokesSolver
from softx_2020_200_tpu_torch.solvers.gls import (GLSOperator, StabFlags,
                                                   probe_columns)
from tests.test_gls_steady import BASE, COUETTE_BCS

torch.set_num_threads(1)

RTOL = 1e-12
NU = 0.05
A0, SDT = 2.0, 4.0
CPU = dict(device="cpu", dtype=torch.float64)


def _mesh(m, dim, kind):
    if kind == "shell":
        return m.hyper_shell([0.0] * dim, 0.25, 1.0, 6 if dim == 2 else 0)
    return m.subdivided_hyper_rectangle([0.0] * dim, [1.0, 0.7, 1.3][:dim],
                                        [3, 2, 2][:dim], colorize=True,
                                        dim=dim)


def _setup(dim, degree, kind, seed):
    sa = JaxFESpace(_mesh(jax_mesh, dim, kind), degree)
    sb = FESpace(_mesh(port_mesh, dim, kind), degree)
    assert sa.n_nodes == sb.n_nodes
    rng = np.random.default_rng(seed)
    N, c, E, nq = sa.n_nodes, dim + 1, sa.n_elements, (degree + 1) ** dim
    data = dict(u=0.3 * rng.standard_normal((N, c)),
                prev=0.2 * rng.standard_normal((N, dim)),
                fq=rng.standard_normal((E, nq, dim)),
                mask=rng.random((N, c)) < 0.2)
    return sa, sb, data


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("frozen", [False, True], ids=["exact", "frozen"])
@pytest.mark.parametrize("kind", ["box", "shell"])
@pytest.mark.parametrize("dim,degree", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_element_matrices_match_jax(dim, degree, kind, frozen):
    """[E, nn*c, nn*c] in the space's element order, constrained rows and
    columns zeroed with a unit diagonal."""
    sa, sb, x = _setup(dim, degree, kind, seed=dim + 3 * degree)
    ja = jax_gls.GLSOperator(sa, nu=NU, dtype=jnp.float64,
                             stab=jax_gls.StabFlags(frozen_tau=frozen))
    op = GLSOperator(sb, nu=NU, stab=StabFlags(frozen_tau=frozen), **CPU)
    assert (op.layout is None) == (kind == "shell")
    if op.layout is not None:
        # the lattice's element order is not the space's
        assert (op.elem_perm != torch.arange(sb.n_elements)).any()
    ref = ja.element_matrices(*(jnp.asarray(x[k]) for k in
                                ("u", "mask", "prev", "fq")), A0, SDT)
    got = op.element_matrices(*(_t(x[k]) for k in
                                ("u", "mask", "prev", "fq")), A0, SDT)
    assert got.shape == ref.shape
    assert _rel(got, ref) < RTOL


def _onehot_columns(run, rows, n_rows, E):
    """[E, n_rows, n_rows]: column k from ``run(due)`` with ``due`` the
    one-hot row k of every element (``rows(k)`` makes it)."""
    cols = [np.asarray(run(rows(k)))[:, :E].T for k in range(n_rows)]
    return np.stack(cols, axis=-1)


@pytest.mark.parametrize("kind", ["shell", "box"])
def test_probe_element_matrices_match_tpu_kernel(kind):
    """The frozen-tau element matrices from one-hot tangent probes of the
    plain kernel (the rows of B1, or of B2 in the lattice's element
    order) against the JAX package's TPU kernel in interpret mode along
    the same one-hot directions."""
    dim, degree = 2, 1
    sa, sb, x = _setup(dim, degree, kind, seed=7)
    nn, c, E = sa.basis.n_nodes, dim + 1, sa.n_elements
    op = GLSOperator(sb, nu=NU, stab=StabFlags(frozen_tau=True), **CPU)
    ja = jax_gls.GLSOperator(sa, nu=NU, dtype=jnp.float64)
    ja.enable_pallas(interpret=True)
    pg = ja._pallas
    u, prev, fq = (jnp.asarray(x[k]) for k in ("u", "prev", "fq"))
    if kind == "shell":
        assert op.layout is None
        en = jnp.asarray(sa.elem_nodes)
        ue2 = pg.to_rows(gather_elements(u, en))
        up2 = pg.to_rows(gather_elements(prev, en))
        fq2 = pg.to_rows(fq)

        def rows(k):
            due = np.zeros((E, nn * c))
            due[:, k] = 1.0
            return pg.to_rows(jnp.asarray(due.reshape(E, nn, c)))

        def run(due2):
            dr = jax.jvp(lambda w: pg.residual_rows(w, up2, fq2, A0, SDT),
                         (ue2,), (due2,))[1]
            return pg.from_rows(dr).T
        ue = op._soa(_t(x["u"]))
        args = (op.xe_soa, op._soa(_t(x["prev"])), op._fq_soa(_t(x["fq"])),
                op.h)
    else:
        assert op.layout is not None
        assert (op.elem_perm != torch.arange(E)).any()
        sl = ja._structured
        ue2 = pg.rows_from_list(sl.gather_rows_list(u), (nn, c))
        up2 = pg.rows_from_list(sl.gather_rows_list(prev), (nn, dim))
        fqg = fq[ja._sl_perm]
        fq2 = pg.rows_from_list([fqg[:, q, i] for q in range(fq.shape[1])
                                 for i in range(dim)], (fq.shape[1], dim))

        def rows(k):
            due = np.zeros(ue2.shape)
            due[k, :E] = 1.0
            return jnp.asarray(due)

        def run(due2):
            return jax.jvp(lambda w: pg.residual_rows(w, up2, fq2, A0, SDT),
                           (ue2,), (due2,))[1]
        ue = op._rows(_t(x["u"]))
        args = (op._rows(_t(x["prev"])), op._fq_rows(_t(x["fq"])))
    got = probe_columns(lambda due: op.kernel.tangent(ue, due, *args, A0,
                                                      SDT), ue)
    got = got.permute(2, 1, 0)                  # [E, row, column]
    ref = _onehot_columns(run, rows, nn * c, E)
    assert got.shape == ref.shape
    assert _rel(got, ref) < RTOL


@pytest.mark.parametrize("order", [1, 2])
def test_couette_additive_schwarz_matches_jax(order):
    """The steady Couette deck of ``tests/test_gls_steady.py`` with
    additive Schwarz: equal Newton iterations, Krylov iterations within 1
    per linear solve, the same solution."""
    text = BASE.format(nu=0.1, order=order, refine=2,
                       precond="additive_schwarz", extra=COUETTE_BCS)
    ja = JaxSolver(JaxParameters.from_text(text, dim=2))
    po = GLSNavierStokesSolver(SimulationParameters.from_text(text, dim=2),
                               **CPU)
    assert po.precond_kind == ja.precond_kind == "additive_schwarz"
    ua, ra = ja.solve_steady(verbose=False)
    up, rp = po.solve_steady(verbose=False)
    newton = int(ra.n_iterations)
    assert rp.n_iterations == newton
    assert abs(rp.linear_iters - int(ra.linear_iters)) <= newton
    assert _rel(up, ua) < 1e-8
    assert rp.res_history[rp.n_iterations] < 1e-10
