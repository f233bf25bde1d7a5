"""The PyTorch package's forest multigrid against the JAX package's, on
the CPU in float64 (analogues of ``tests/test_forest_gmg.py``).

The lid-driven cavity on a forest is refined towards its lid corners,
the same leaves in both packages, so that every level but the coarsest
has hanging faces; Q2 adds the Q1 p-level on the same forest mesh.  The
levels (transfers, masks, hanging constraints, the interpolated Newton
state), one cycle, and the Newton and Krylov counts of a steady solve
must agree; the grad-div (GD) velocity-block hierarchy likewise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softx_2020_200_tpu.core.parameters import \
    SimulationParameters as JaxParameters
from softx_2020_200_tpu.ops.gd_multigrid import \
    build_gd_hierarchy as jax_gd_hierarchy
from softx_2020_200_tpu.ops.multigrid import build_hierarchy as jax_hierarchy
from softx_2020_200_tpu.solvers.base import \
    GLSNavierStokesSolver as JaxSolver
from softx_2020_200_tpu.solvers.gd import GDNavierStokesSolver as JaxGD
from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
from softx_2020_200_tpu_torch.solvers.base import GLSNavierStokesSolver
from softx_2020_200_tpu_torch.solvers.gd import GDNavierStokesSolver
from tests.test_forest_gmg import CAVITY_FOREST

torch.set_num_threads(1)
KW = dict(device="cpu", dtype=torch.float64)


def _deck(order: int, gd: bool = False) -> str:
    text = CAVITY_FOREST.format(refine=4, precond="gmg")
    if gd:
        return text.replace("subsection mesh\n", "subsection FEM\n  set "
                            "pressure order = 1\nend\nsubsection mesh\n")
    return text.replace("subsection mesh\n", "subsection FEM\n  set velocity "
                        f"order = {order}\n  set pressure order = {order}\n"
                        "end\nsubsection mesh\n")


def _adapt(solver):
    """Refine the cells touching the lid's two corners, twice (the same
    leaves in either package), and rebuild the solver on the forest."""
    f = solver.forest
    for _ in range(2):
        b, lvl, idx = f._leaf_arrays_only()
        n = 1 << lvl
        top = idx[:, 1] == n - 1
        side = (idx[:, 0] == 0) | (idx[:, 0] == n - 1)
        f.refine(np.column_stack([b, lvl, idx])[top & side])
        f.balance()
    mesh, solver._elem_of, ncf = f.build_mesh()
    solver.setup(mesh=mesh, nc_faces=ncf)
    return solver


def _pair(order: int, gd: bool = False):
    text = _deck(order, gd)
    if gd:
        a = JaxGD(JaxParameters.from_text(text, dim=2))
        b = GDNavierStokesSolver(SimulationParameters.from_text(text, dim=2),
                                 **KW)
    else:
        a = JaxSolver(JaxParameters.from_text(text, dim=2))
        b = GLSNavierStokesSolver(SimulationParameters.from_text(text, dim=2),
                                  **KW)
    return _adapt(a), _adapt(b)


def _eq(got, want, exact=False):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    if exact:
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-13)


def _check_hc(hc, ids, masters, weights):
    _eq(hc.ids, ids, exact=True)
    if len(ids):
        _eq(hc.masters, masters, exact=True)
        _eq(hc.weights, weights)


@pytest.mark.parametrize("order", [1, 2])
def test_forest_levels_match_jax(order):
    """Every level: its size, Dirichlet-and-hanging mask, hanging
    constraints, prolongation and state interpolation; hanging faces on
    every level above the coarsest, and the p-level first for Q2."""
    a, b = _pair(order)
    ops, mg = jax_hierarchy(a)
    levels = b.mg_levels
    assert len(levels) == len(ops) >= 3
    assert b.precond_kind == "gmg"
    degrees = [lvl.op.space.degree for lvl in levels]
    assert degrees == [op.space.degree for op in ops]
    assert degrees[:2] == ([2, 1] if order == 2 else [1, 1])
    for li, (lvl, op, C) in enumerate(zip(levels, ops, mg)):
        assert lvl.op.n_nodes == op.n_nodes
        assert lvl.op.space.n_elements == op.space.n_elements
        _check_hc(lvl.hc, C["hc_ids"], C["hc_masters"], C["hc_weights"])
        if li < len(levels) - 1:
            assert lvl.hc.n > 0
        if li == 0:
            continue
        _eq(lvl.mask, C["bh_mask"], exact=True)
        for key in ("masters", "inj_masters"):
            _eq(getattr(lvl, key), C[key], exact=True)
        for key in ("weights", "inj_weights"):
            _eq(getattr(lvl, key), C[key])


def _state(space, dim, seed):
    """A seeded smooth state on the space's nodes."""
    x = np.asarray(space.nodes)
    rng = np.random.default_rng(seed)
    k = rng.uniform(1.0, 3.0, size=(dim + 1, dim))
    return np.stack([np.sin(x @ k[i]) for i in range(dim + 1)], axis=1)


@pytest.mark.parametrize("order", [1, 2])
def test_forest_cycle_matches_jax(order):
    """One cycle of each package's forest hierarchy (the deck's steady
    Krylov smoother), linearized at the same state, on the same
    residual."""
    a, b = _pair(order)
    u = _state(a.space, 2, order)
    r = _state(a.space, 2, order + 10)
    mask_a = a.bh.mask.at[a.hc.ids].set(True)
    uprev = jnp.zeros((a.space.n_nodes, 2))
    fq = jnp.zeros((a.space.n_elements, a.op.n_q, 2))
    want = jax.jit(lambda u, r, mg: a._mg_builder(
        a.hc.distribute(u), uprev, fq, 0.0, 0.0, mask_a, mg)(
        jnp.where(mask_a, 0.0, r)))(jnp.asarray(u), jnp.asarray(r),
                                    a._consts["mg"])
    mask_b = b.bh.mask.clone()
    mask_b[b.hc.ids] = True
    ut = b.hc.distribute(torch.from_numpy(u))
    got = b._vcycle(ut, torch.zeros(b.space.n_nodes, 2, dtype=torch.float64),
                    torch.zeros(b.space.n_elements, b.op.n_q, 2,
                                dtype=torch.float64), 0.0, 0.0, mask_b)(
        torch.where(mask_b, 0.0, torch.from_numpy(r)))
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-9 * scale)


@pytest.mark.parametrize("order", [1, 2])
def test_forest_gmg_newton_counts_match_jax(order):
    """A steady solve on the adapted cavity with forest GMG (FGMRES):
    the JAX package's Newton iterations, its Krylov iterations within 1
    per linear solve, and its solution."""
    a, b = _pair(order)
    ua, ra = a.solve_steady()
    ub, rb = b.solve_steady()
    assert b.precond_kind == "gmg" and b.stats["solves_above_tolerance"] == 0
    n = int(ra.n_iterations)
    assert rb.n_iterations == n
    assert abs(rb.linear_iters - int(ra.linear_iters)) <= n
    np.testing.assert_allclose(ub.numpy()[:, :2], np.asarray(ua)[:, :2],
                               rtol=0, atol=1e-7)


def test_gd_forest_levels_and_cycle_match_jax():
    """The GD velocity-block hierarchy on the adapted forest (levels,
    masks, hanging constraints, transfers), one V-cycle linearized at
    the same velocity, and the Newton and Krylov counts of a steady
    solve."""
    a, b = _pair(1, gd=True)
    levels, consts = jax_gd_hierarchy(a)
    assert len(b.mg_levels) == len(levels) >= 3
    for li, (lvl, jl, C) in enumerate(zip(b.mg_levels, levels, consts)):
        assert lvl.op.N == jl.N
        _eq(lvl.mask, C["mask"], exact=True)
        hc = C["hc"]
        _check_hc(lvl.hc, hc.ids, hc.masters, hc.weights)
        if li < len(levels) - 1:
            assert lvl.hc.n > 0
        if li:
            for key in ("masters", "inj_masters"):
                _eq(getattr(lvl, key), C[key], exact=True)
            for key in ("weights", "inj_weights"):
                _eq(getattr(lvl, key), C[key])
    v = _state(a.op.space_v, 2, 5)[:, :2]
    r = _state(a.op.space_v, 2, 6)[:, :2]
    want = a._mg_builder(jnp.asarray(v), 0.0)(jnp.asarray(r))
    got = b._mg_builder(torch.from_numpy(v), 0.0)(torch.from_numpy(r))
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-9 * scale)
    xa, ra = a.solve_steady()
    xb, rb = b.solve_steady()
    n = int(ra.n_iterations)
    assert rb.n_iterations == n
    assert abs(rb.linear_iters - int(ra.linear_iters)) <= n
    np.testing.assert_allclose(xb.numpy(), np.asarray(xa), rtol=0, atol=1e-7)
