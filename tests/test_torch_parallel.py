"""The PyTorch package's sharded path on the CPU in float64 (analogues of
``tests/test_parallel.py`` and ``__graft_entry__.py::dryrun_multichip``).

Shards are a list of devices driven by one process; here every shard is
on the CPU.  The port's Morton partition is the JAX package's (array for
array, exchange for exchange); the ghost refresh and the partial-sum
combine are the global gather and scatter; the sharded residual and
tangent are the one-device ones at any shard count, and the JAX
package's sharded residual on 4 virtual devices; and sharded solves
reproduce one-device solves: a Couette solve, 3 BDF2 steps of MMS with
multigrid and one Kelly cycle at 8 shards, and the GD engine's solve.
"""

import numpy as np
import pytest
import torch

from softx_2020_200_tpu.core.parameters import \
    SimulationParameters as JaxParameters
from softx_2020_200_tpu.fem import mesh as jax_mesh
from softx_2020_200_tpu.fem.dof import FESpace as JaxFESpace
from softx_2020_200_tpu.parallel.partition import \
    partition_space as jax_partition
from softx_2020_200_tpu.solvers.base import \
    GLSNavierStokesSolver as JaxSolver
from softx_2020_200_tpu_torch.core.bdf import bdf_coefficients
from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
from softx_2020_200_tpu_torch.fem import mesh as port_mesh
from softx_2020_200_tpu_torch.fem.dof import FESpace
from softx_2020_200_tpu_torch.ops.multigrid import build_hierarchy
from softx_2020_200_tpu_torch.parallel.partition import (morton_order,
                                                         partition_space)
from softx_2020_200_tpu_torch.parallel.sharded import (Exchanges,
                                                       ShardedGLSSolver,
                                                       ShardVec)
from softx_2020_200_tpu_torch.parallel.sharded_gd import ShardedGDSolver
from softx_2020_200_tpu_torch.solvers.base import GLSNavierStokesSolver
from softx_2020_200_tpu_torch.solvers.gd import GDNavierStokesSolver
from tests.test_sharded_v2 import MMS_DECK

torch.set_num_threads(1)
KW = dict(device="cpu", dtype=torch.float64)
# interior leaves of the 8x8 MMS mesh refined once more: hanging nodes
# without touching the Dirichlet data (tests/test_sharded_v2.py)
MARKS = (9, 18, 27, 36)


def _adapted(pkg: str, order: int = 1, refine: int = 3, marks=MARKS):
    """The MMS deck on a forest with the ``marks`` leaves refined once
    (hanging nodes), in the JAX package or the port."""
    deck = MMS_DECK.replace("subsection test", "subsection mesh adaptation"
                            "\n  set type = kelly\nend\nsubsection test")
    text = deck.format(refine=refine, order=order)
    if pkg == "jax":
        s = JaxSolver(JaxParameters.from_text(text, dim=2))
    else:
        s = GLSNavierStokesSolver(SimulationParameters.from_text(text, dim=2),
                                  **KW)
    leaves = s.forest.all_leaves()
    s.forest.refine([leaves[i] for i in marks])
    s.forest.balance()
    mesh, elem_of, ncf = s.forest.build_mesh()
    s._elem_of = elem_of
    s.setup(mesh=mesh, nc_faces=ncf)
    assert s.hc.n > 0
    return s


def _mms(order: int = 2, refine: int = 2):
    return GLSNavierStokesSolver(SimulationParameters.from_text(
        MMS_DECK.format(refine=refine, order=order), dim=2), **KW)


def _spaces(kind: str):
    """(JAX space, port space, JAX hc, port hc) of one partition case."""
    if kind == "shell":
        def space(m, F):
            return F(m.hyper_shell([0.0, 0.0], 0.25, 1.0, 6)
                     .refine_uniform(2), 2)
        return (space(jax_mesh, JaxFESpace), space(port_mesh, FESpace),
                None, None)
    if kind == "box":
        def space(m, F):
            return F(m.subdivided_hyper_rectangle(
                [0.0, 0.0], [1.0, 0.7], [6, 5], colorize=True, dim=2), 1)
        return (space(jax_mesh, JaxFESpace), space(port_mesh, FESpace),
                None, None)
    j, p = _adapted("jax"), _adapted("port")
    return j.space, p.space, j.hc, p.hc.to("cpu", torch.float64)


@pytest.mark.parametrize("kind,P", [("shell", 8), ("box", 4),
                                    ("forest", 4)])
def test_partition_matches_jax(kind, P):
    """The port's copy of ``partition_space`` gives the JAX package's
    layout: every array, and every exchange."""
    js, ps, jhc, phc = _spaces(kind)
    want, got = jax_partition(js, P, hc=jhc), partition_space(ps, P, hc=phc)
    for name in ("n_shards", "dim", "degree", "n_nodes_global", "N_loc",
                 "E_loc", "nn"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("elem_nodes", "elem_valid", "xe", "owned_mask", "l2g",
                 "assembly_idx"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)), name)
    assert len(got.exchanges) == len(want.exchanges) > 0
    for a, b in zip(got.exchanges, want.exchanges):
        assert a.delta == b.delta
        for name in ("send_idx", "recv_idx", "valid"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name))
    # every element once, every node owned once
    assert int(got.elem_valid.sum()) == ps.n_elements
    own = got.l2g[got.owned_mask > 0]
    assert np.array_equal(np.sort(own), np.arange(ps.n_nodes))
    if kind == "forest":
        assert P > 1 and phc.n > 0


def test_morton_order_locality():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 1, size=(256, 2))
    order = morton_order(pts)
    d = np.linalg.norm(np.diff(pts[order], axis=0), axis=1)
    d_rand = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    assert d.mean() < 0.5 * d_rand.mean()


@pytest.mark.parametrize("kind,P", [("shell", 8), ("forest", 4)])
def test_refresh_and_combine_are_global_gather_and_scatter(kind, P):
    """Ghost refresh fills every ghost with its owner's value (the
    global gather); the combine leaves in each owned slot the sum of the
    partials of every shard that holds the node (the global scatter)."""
    _, ps, _, phc = _spaces(kind)
    L = partition_space(ps, P, hc=phc)
    ex = Exchanges(L, ["cpu"] * P)
    rng = np.random.default_rng(3)
    u = rng.standard_normal((ps.n_nodes, 3))
    full = L.to_local(u)
    owned_only = full * L.owned_mask[..., None]
    got = ex.refresh(ShardVec(torch.as_tensor(x) for x in owned_only))
    for p in range(P):
        np.testing.assert_array_equal(got.parts[p].numpy(), full[p])
    valid = (L.l2g >= 0)[..., None]
    partial = rng.standard_normal(full.shape) * valid
    total = np.zeros_like(u)
    np.add.at(total, L.l2g[valid[..., 0]], partial[valid[..., 0]])
    got = ex.combine(ShardVec(torch.as_tensor(x.copy()) for x in partial))
    for p in range(P):
        own = L.owned_mask[p] > 0
        np.testing.assert_allclose(got.parts[p].numpy()[own],
                                   total[L.l2g[p][own]], rtol=0,
                                   atol=1e-14 * np.abs(total).max())


def _fields(s, seed):
    rng = np.random.default_rng(seed)
    N, d = s.space.n_nodes, s.dim
    return (torch.as_tensor(rng.standard_normal((N, d + 1))),
            torch.as_tensor(rng.standard_normal((N, d + 1))),
            torch.as_tensor(0.3 * rng.standard_normal((N, d))))


@pytest.mark.parametrize("P", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["box", "forest"])
def test_sharded_residual_and_tangent_match_one_device(kind, P):
    """R(u) and J(u) v of the sharded operator (B1's plain version per
    shard) equal the one-device engine's within 1e-12 of scale: the Q2
    MMS box (one device on the lattice path) and the Q1 MMS deck on a
    forest with hanging nodes, with the source, the time-dependent
    Dirichlet data and a BDF term."""
    s = _mms() if kind == "box" else _adapted("port")
    u, v, combo = _fields(s, 7)
    t, a0, sdt = 0.1, 15.0, 10.0
    constrain, residual, jacobian = s._make_problem(combo, t, a0, sdt)[:3]
    uc = constrain(u)
    R0, J0 = residual(uc), jacobian(uc)(v)

    sh = ShardedGLSSolver.from_solver(s, ["cpu"] * P)
    pb = sh._problem(sh.to_local(combo), t, a0, sdt)
    ul = sh._constrain(sh.to_local(u), pb)
    R = sh.to_global(sh.residual(ul, pb))
    J = sh.to_global(sh.jacobian(ul, pb)(sh.to_local(v)))
    for got, want in ((R, R0), (J, J0)):
        scale = float(want.abs().max())
        assert scale > 0
        assert float((got - want).abs().max()) <= 1e-12 * scale


def test_sharded_residual_matches_jax_sharded():
    """The port's sharded residual against the JAX package's
    ``ShardedGLSSolver.residual_global`` on 4 virtual CPU devices (the
    adapted MMS deck, hanging rows localized in both)."""
    import jax
    from softx_2020_200_tpu.parallel.sharded import \
        ShardedGLSSolver as JaxSharded
    j, s = _adapted("jax"), _adapted("port")
    u, _, combo = _fields(s, 11)
    t, a0, sdt = 0.1, 15.0, 10.0
    want = JaxSharded.from_solver(j, devices=jax.devices()[:4]) \
        .residual_global(u.numpy(), combo.numpy(), t=t, alpha0=a0, sdt=sdt)
    got = ShardedGLSSolver.from_solver(s, ["cpu"] * 4).residual_global(
        u, combo, t=t, alpha0=a0, sdt=sdt).numpy()
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)


def test_sharded_couette_matches_one_device():
    """The steady Couette solve of ``tests/test_parallel.py`` at 8
    shards: the one-device solution within 5e-8, Newton within 2."""
    from tests.test_gls_steady import BASE, COUETTE_BCS
    s = GLSNavierStokesSolver(SimulationParameters.from_text(
        BASE.format(nu=0.1, order=1, refine=3, precond="block_jacobi",
                    extra=COUETTE_BCS), dim=2), **KW)
    u_ref, res = s.solve_steady(verbose=False)
    sh = ShardedGLSSolver.from_solver(s, ["cpu"] * 8)
    u, got = sh.solve(torch.zeros_like(u_ref))
    assert float((u - u_ref).abs().max()) < 5e-8
    assert got.n_iterations <= res.n_iterations + 2


def _dryrun_solver(refine: int):
    from __graft_entry__ import _MMS_DECK
    deck = _MMS_DECK.replace(
        "subsection test", "subsection mesh adaptation\n  set type = kelly"
        "\n  set fraction refinement = 0.15\nend\nsubsection test")
    return GLSNavierStokesSolver(SimulationParameters.from_text(
        deck.format(refine=refine), dim=2), **KW)


def _parity(u, u_ref, d):
    """(max velocity difference, max mean-shifted pressure difference)."""
    dv = float((u[:, :d] - u_ref[:, :d]).abs().max())
    dp = u[:, d] - u_ref[:, d]
    return dv, float((dp - dp.mean()).abs().max())


def test_dryrun_multichip_analogue():
    """``dryrun_multichip(8)`` on the port: 3 BDF2 steps of the MMS deck
    (source, moving Dirichlet data) with multigrid over 8 shards against
    one device (the JAX package's f64 dry run: velocity 6.62e-12,
    pressure 5.98e-11); then one adaptation of half the interior leaves
    (hanging nodes), the history transferred, one BDF1 step 1 against 8
    on the re-sharded forest."""
    from softx_2020_200_tpu_torch.fem.forest import Forest
    from softx_2020_200_tpu_torch.fem.transfer import transfer_solution
    s = _dryrun_solver(4)
    dt, d = 0.1, s.dim
    u0 = s.initial_condition()
    u_ref, previous = u0, [u0, u0, u0]
    for k in range(3):
        order = min(2, k + 1)
        u_ref, _ = s.solve_transient_step(u_ref, previous, (k + 1) * dt,
                                          [dt] * order, order)
        previous = [u_ref] + previous[:2]
    mg = build_hierarchy(s, min_elems=2)
    assert len(mg) >= 2
    sh = ShardedGLSSolver(
        s.space, s.op.nu, ["cpu"] * 8, stab=s.op.stab, newton=s.newton_cfg,
        dtype=torch.float64, precond="gmg", mg=mg,
        source_fn=s._mms_source, bc_exprs=s.bh.function_entries,
        bc_mask=s.bh.mask)
    u = sh.to_global(sh.run_transient(sh.to_local(u0), dt, 3, order=2))
    assert torch.isfinite(u).all()
    dv, dp = _parity(u, u_ref, d)
    assert dv <= 1e-11 and dp <= 1e-10, (dv, dp)

    nodes, conn = s.space.nodes, s.space.elem_nodes
    exy = nodes[conn]
    lo, hi = nodes.min(0), nodes.max(0)
    interior = ((exy.min(1) > lo + 1e-9) & (exy.max(1) < hi - 1e-9)).all(1)
    leaves = s.forest.all_leaves()
    snap = Forest.__new__(Forest)
    snap.base, snap.dim = s.forest.base, s.forest.dim
    snap.leaves = [set(x) for x in s.forest.leaves]
    snap._adjacency = s.forest._adjacency
    old_space, old_elem_of = s.space, s._elem_of
    s.forest.refine([leaves[e] for e in np.nonzero(interior)[0][::2]])
    s.forest.balance()
    mesh, elem_of, ncf = s.forest.build_mesh()
    s._elem_of = elem_of
    s.setup(mesh=mesh, nc_faces=ncf)
    u_ref, prev1 = transfer_solution(old_space, snap, old_elem_of, s.space,
                                     s.forest, elem_of, [u_ref, previous[0]])
    assert s.hc.n > 0
    u0a = s.bh.constrain(u_ref, 4 * dt)
    u_ref2, _ = s.solve_transient_step(u0a, [prev1], 4 * dt, [dt], 1)
    sh2 = ShardedGLSSolver.from_solver(s, ["cpu"] * 8)
    assert sh2.hc is not None
    a = bdf_coefficients(1, [dt])
    u2, _ = sh2.solve(u0a, uprev_combo_global=float(a[1]) * prev1[:, :d],
                      alpha0=float(a[0]), sdt=1.0 / dt, t=4 * dt)
    dv, dp = _parity(u2, u_ref2, d)
    assert dv <= 1e-11 and dp <= 1e-10, (dv, dp)


@pytest.mark.parametrize("P", [2, 8])
def test_sharded_gd_matches_one_device(P):
    """The GD engine's BDF1 step on the golden MMS deck through
    ``ShardedGDSolver`` (the engine's hook) against the engine alone: the
    same solution within 1e-10, the same Newton iterations."""
    import os
    from tests.test_golden_apps import GOLDEN_DIR
    prm = SimulationParameters.from_file(
        os.path.join(GOLDEN_DIR, "gd_mms_bdf2.prm"), dim=2)
    s = GDNavierStokesSolver(prm, **KW)
    x0 = s.initial_condition()
    dt = 0.1
    ref, res = s.solve_transient_step(x0, [x0], dt, [dt], 1)
    sh = ShardedGDSolver.from_solver(s, ["cpu"] * P)
    s._sharded_hook = lambda x, combo, t, a0: sh.solve(x, combo, t, a0)
    got, res_p = s.solve_transient_step(x0, [x0], dt, [dt], 1)
    assert res_p.n_iterations == res.n_iterations
    assert float((got - ref).abs().max()) <= 1e-10 * float(ref.abs().max())
