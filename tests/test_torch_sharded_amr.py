"""The port's sharded GLS solver against the JAX package's one-device
solves, on the CPU in float64: the cases of ``tests/test_sharded_v2.py``
on adapted meshes (hanging rows localized per shard, with and without
forest multigrid) and the transient driver, each with that test's
tolerances, every shard on the CPU.
"""

import numpy as np
import pytest
import torch

from softx_2020_200_tpu_torch.ops.multigrid import build_hierarchy
from softx_2020_200_tpu_torch.parallel.sharded import ShardedGLSSolver
from tests.test_sharded_v2 import make_adapted_mms_solver, make_mms_solver
from tests.test_torch_parallel import MARKS, _adapted
from tests.test_torch_sharded_solvers import (DT, _errors, _jax_step, _port,
                                              _sharded, _step)

torch.set_num_threads(1)


@pytest.mark.parametrize("order", [1, 2])
def test_sharded_adapted_mesh_parity(order):
    """1-vs-8 on an adapted mesh (hanging rows localized per shard),
    against the JAX package's step; the answer satisfies the
    constraints."""
    j = make_adapted_mms_solver(order=order)
    u0, u_ref = _jax_step(j)
    s = _adapted("port", order=order, marks=(9, 36))
    assert s.hc.n == j.hc.n
    sh = ShardedGLSSolver.from_solver(s, ["cpu"] * 8)
    assert sh.hc is not None
    u, _ = _step(sh, u0)
    assert np.abs(u - u_ref).max() < 1e-8
    ut = torch.as_tensor(u)
    assert float((s.hc.distribute(ut) - ut).abs().max()) < 1e-12


def test_sharded_adapted_gmg_parity():
    """Forest multigrid on an adapted mesh (interpolated state, coarse
    hanging rows), 4 shards, against the JAX package's step."""
    u0, u_ref = _jax_step(make_adapted_mms_solver(refine=3, order=1,
                                                  marks=MARKS))
    s = _adapted("port", order=1, marks=MARKS)
    mg = build_hierarchy(s, min_elems=2)
    assert len(mg) >= 2
    u, _ = _step(_sharded(s, 4, precond="gmg", mg=mg, hc=s.hc), u0)
    ev, ep = _errors(u, u_ref)
    assert ev < 1e-8 and ep < 1e-7, (ev, ep)


def test_sharded_transient_driver_parity():
    """3 BDF2 steps (order ramp) through the sharded driver against the
    JAX package's one-device loop; the MMS solution is tracked."""
    j = make_mms_solver(refine=2, order=2)
    u = u0 = j.initial_condition()
    previous = [u0, u0, u0]
    for k in range(3):
        order = min(2, k + 1)
        u, _ = j.solve_transient_step(u, previous, (k + 1) * DT,
                                      [DT] * order, order, verbose=False)
        previous = [u] + previous[:2]
    s = _port(2, 2)
    sh = ShardedGLSSolver.from_solver(s, ["cpu"] * 8)
    got = sh.to_global(sh.run_transient(sh.to_local(np.asarray(u0)), DT, 3,
                                        order=2))
    assert np.abs(got.numpy() - np.asarray(u)).max() < 1e-8
    ev, _ = s.l2_errors(got, 3 * DT)
    assert ev < 5e-3
