"""The port's sharded GLS solver against the JAX package's one-device
solves, on the CPU in float64: the cases of ``tests/test_sharded_v2.py``
on fixed meshes (the MMS source, multigrid with the V- and K-cycle, the
Q2 -> Q1 p-level with the Krylov smoother), each with that test's
tolerances and iteration checks, every shard on the CPU.  The adapted
meshes and the transient driver are in
``tests/test_torch_sharded_amr.py``.
"""

import numpy as np
import torch

from softx_2020_200_tpu_torch.core.bdf import bdf_coefficients
from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
from softx_2020_200_tpu_torch.ops.multigrid import build_hierarchy
from softx_2020_200_tpu_torch.parallel.sharded import ShardedGLSSolver
from softx_2020_200_tpu_torch.solvers.base import GLSNavierStokesSolver
from tests.test_sharded_v2 import MMS_DECK, _single_step, make_mms_solver

torch.set_num_threads(1)
KW = dict(device="cpu", dtype=torch.float64)
DT = 0.1


def _port(refine, order):
    return GLSNavierStokesSolver(SimulationParameters.from_text(
        MMS_DECK.format(refine=refine, order=order), dim=2), **KW)


def _jax_step(jax_solver):
    """(u0, the JAX package's one-device BDF1 step from it) as arrays."""
    u0, u_ref, _ = _single_step(jax_solver, DT)
    return np.asarray(u0), np.asarray(u_ref)


def _sharded(s, P, **kw):
    """A sharded solver with the engine's physics and Newton settings and
    the options ``kw`` (the JAX tests' direct constructor)."""
    return ShardedGLSSolver(
        s.space, s.op.nu, ["cpu"] * P, stab=s.op.stab, newton=s.newton_cfg,
        dtype=torch.float64, source_fn=s._mms_source,
        bc_exprs=s.bh.function_entries, bc_mask=s.bh.mask, **kw)


def _step(sh, u0):
    """One sharded BDF1 step from u0: (u [N, c] numpy, NewtonResult)."""
    a = bdf_coefficients(1, [DT])
    u, res = sh.solve(u0, uprev_combo_global=float(a[1]) * u0[:, :2],
                      alpha0=float(a[0]), sdt=1.0 / DT, t=DT)
    return u.numpy(), res


def _errors(u, u_ref, d=2):
    """Velocity exactly, pressure mean-shifted (enclosed flow)."""
    dp = u[:, d] - u_ref[:, d]
    return np.abs(u[:, :d] - u_ref[:, :d]).max(), np.abs(dp - dp.mean()).max()


def test_sharded_mms_source_parity():
    """1-vs-8 parity of one Q2 BDF1 step with the MMS forcing, against
    the JAX package's step; without the source the answer moves."""
    u0, u_ref = _jax_step(make_mms_solver(order=2))
    s = _port(2, 2)
    u, _ = _step(ShardedGLSSolver.from_solver(s, ["cpu"] * 8), u0)
    assert np.abs(u - u_ref).max() < 1e-8
    nosrc = ShardedGLSSolver(s.space, s.op.nu, ["cpu"] * 8, stab=s.op.stab,
                             newton=s.newton_cfg, dtype=torch.float64,
                             bc_exprs=s.bh.function_entries,
                             bc_mask=s.bh.mask)
    u_nos, _ = _step(nosrc, u0)
    assert np.abs(u_nos - u).max() > 1e-6


def test_sharded_gmg_parity_and_strength():
    """Q1 8x8, 4 shards: GMG (V-cycle, coarse levels whole) reaches the
    JAX package's step, in fewer Krylov iterations than block-Jacobi;
    the K-cycle (wrapped at the coarse root) reaches it too, in at most
    2 iterations more than the V-cycle."""
    u0, u_ref = _jax_step(make_mms_solver(refine=3, order=1))
    s = _port(3, 1)
    mg = build_hierarchy(s, min_elems=2)
    assert len(mg) >= 2
    u, res = _step(_sharded(s, 4, precond="gmg", mg=mg), u0)
    ev, ep = _errors(u, u_ref)
    assert ev < 1e-9 and ep < 1e-9, (ev, ep)
    _, res_bj = _step(_sharded(s, 4, precond="block_jacobi"), u0)
    assert res.linear_iters < res_bj.linear_iters
    u_k, res_k = _step(_sharded(s, 4, precond="gmg", mg=mg, mg_cycle="k"),
                       u0)
    assert _errors(u_k, u_ref)[0] < 1e-9
    assert res_k.linear_iters <= res.linear_iters + 2


def test_sharded_gmg_q2_pmg_krylov_parity():
    """Q2 8x8, 4 shards: the p-coarsened hierarchy (Q1 on the same
    lattice) with the GMRES fine smoother reaches the JAX package's
    step, in fewer Krylov iterations than block-Jacobi."""
    u0, u_ref = _jax_step(make_mms_solver(refine=3, order=2))
    s = _port(3, 2)
    mg = build_hierarchy(s, min_elems=2)
    assert mg[1].op.space.degree == 1
    assert mg[1].op.space.n_elements == s.space.n_elements
    u, res = _step(_sharded(s, 4, precond="gmg", mg=mg,
                            mg_smoother="krylov"), u0)
    ev, ep = _errors(u, u_ref)
    assert ev < 1e-9 and ep < 1e-9, (ev, ep)
    _, res_bj = _step(_sharded(s, 4, precond="block_jacobi"), u0)
    assert res.linear_iters < res_bj.linear_iters
