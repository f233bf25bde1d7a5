"""The Taylor-Green vortex in Q2-Q2 on a periodic 3D lattice, the deck of
the benchmark's ``tgv_re1600_q2`` configuration at 4^3 cells, on the CPU
in float64:

- the port's residual against the benchmark's plain reference
  (``benchmark/reference``) at seeded random BDF1 and BDF2 states;
- the lattice hierarchy: a Q2 level, a Q1 p-level on the same lattice
  with 2 Gauss points per axis, Q1 h-levels with 3;
- three solves (the BDF2 start-up and one constant step) against the
  JAX package's solver with the same hierarchy: the same Newton and
  FGMRES counts, the states within 1e-10, every solve to the deck's
  tolerance by the reference's measure;
- the p-level's gather counter: the bytes of its injection,
  prolongation and restriction from their shapes, to the byte, also
  counted under ``transfer``.
"""

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import softx_2020_200_tpu.ops.multigrid as jax_mg
import softx_2020_200_tpu_torch.solvers.base as port_base
from benchmark import traffic
from benchmark.reference.check import Judge
from benchmark.reference.gls import bdf_weights
from softx_2020_200_tpu.core.parameters import \
    SimulationParameters as JaxParameters
from softx_2020_200_tpu.solvers.base import \
    GLSNavierStokesSolver as JaxSolver
from softx_2020_200_tpu_torch.core import spans
from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
from softx_2020_200_tpu_torch.ops.multigrid import (build_hierarchy,
                                                    make_vcycle, prolong,
                                                    restrict)
from softx_2020_200_tpu_torch.solvers.base import (GLSNavierStokesSolver,
                                                   new_stats)

torch.set_num_threads(1)

L = "6.283185307179586"
SEED = 2 ** 31 + 7
# 4^3 halves once to 2^3: with this floor the deck's hierarchy has an
# h-level below its p-level
MIN_ELEMS = 8


def _deck(tmp_path, time_end="0.04"):
    """The configuration's deck at 4^3 cells with the seed's field."""
    cell = traffic.load_cell("tgv_re1600_q2.n64")
    cell["deck"] = {
        "mesh": {"grid arguments":
                 f"4, 4, 4 : 0, 0, 0 : {L}, {L}, {L} : true"},
        "simulation control": {"time end": time_end,
                               "output path": f"{tmp_path}/"}}
    return traffic.deck_for(cell, SEED)


def _port(deck):
    return GLSNavierStokesSolver(
        SimulationParameters.from_text(traffic.render(deck), 3),
        device="cpu", dtype=torch.float64)


def test_residual_matches_the_reference(tmp_path):
    deck = _deck(tmp_path)
    s = _port(deck)
    assert s.op.degree == 2 and s.op.layout is not None
    judge = Judge(deck, 3, s.space.nodes, "cpu")
    gen = torch.Generator().manual_seed(11)
    u0 = s.initial_condition()
    assert judge.ic_err(u0) < 1e-13
    dt = s.prm.simulation_control.dt
    for k, dts in ((1, [0.4 * dt]), (2, [dt, 0.6 * dt]), (2, [dt, dt])):
        hist = [u0 + 0.05 * torch.randn(u0.shape, generator=gen,
                                        dtype=u0.dtype) for _ in range(k)]
        new = u0 + 0.05 * torch.randn(u0.shape, generator=gen,
                                      dtype=u0.dtype)
        alpha = bdf_weights(dts)
        combo = sum(float(a) * h[:, :3] for a, h in zip(alpha[1:], hist))
        want = s._make_problem(combo, 0.0, float(alpha[0]),
                               1.0 / dts[0])[1](new)
        got = judge.residual(judge.ref_order(new), judge.ref_order(
            torch.cat([combo, torch.zeros_like(new[:, 3:])], 1))[:, :3],
            float(alpha[0]), 1.0 / dts[0])
        scale = float(want.abs().max())
        assert float((got[judge.perm] - want).abs().max()) < 1e-11 * scale
        norm = float(torch.linalg.vector_norm(want))
        assert abs(judge.res(new, hist, dts) - norm) < 1e-11 * norm


def test_hierarchy_has_a_p_level_then_h_levels(tmp_path):
    s = _port(_deck(tmp_path))
    levels = build_hierarchy(s, min_elems=MIN_ELEMS)
    shape = [(lv.op.degree, round(lv.op.n_q ** (1 / 3)), lv.op.n_nodes,
              lv.op.layout is not None, lv.part) for lv in levels]
    assert shape == [(2, 3, 512, True, None), (1, 2, 64, True, "transfer_p"),
                     (1, 3, 8, True, None)]
    # the deck's own hierarchy at this size: the p-level alone
    assert [lv.op.degree for lv in s.mg_levels] == [2, 1]
    assert s.precond_kind == "gmg"


def _recorded(solver, records):
    step = solver.solve_transient_step

    def recorded(*args, **kwargs):
        u, res = step(*args, **kwargs)
        records.append((int(res.n_iterations), int(res.linear_iters)))
        solver.chain.append(u)
        return u, res

    solver.chain = []
    solver.solve_transient_step = recorded


def test_steps_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_mg, "build_hierarchy", functools.partial(
        jax_mg.build_hierarchy, min_elems=MIN_ELEMS))
    monkeypatch.setattr(port_base, "build_hierarchy", functools.partial(
        port_base.build_hierarchy, min_elems=MIN_ELEMS))
    deck = _deck(tmp_path)
    text = traffic.render(deck)
    po = _port(deck)
    ja = JaxSolver(JaxParameters.from_text(text, dim=3))
    assert len(po.mg_levels) == len(ja._mg_ops) == 3
    rec_p, rec_a = [], []
    _recorded(po, rec_p)
    _recorded(ja, rec_a)
    u0 = po.initial_condition()
    up = po.run_transient(u0=u0, verbose=False)
    ua = np.asarray(ja.run_transient(verbose=False))
    assert len(rec_p) == 3 and rec_p == rec_a
    assert po.stats["solves_above_tolerance"] == 0
    up = up.numpy()
    assert np.abs(up[:, :3] - ua[:, :3]).max() < 1e-10 * np.abs(ua).max()
    # a periodic box leaves the pressure's constant to the Krylov path
    pp, pa = up[:, 3] - up[:, 3].mean(), ua[:, 3] - ua[:, 3].mean()
    assert np.abs(pp - pa).max() < 1e-10 * np.abs(pa).max()
    # every solve to the deck's tolerance by the reference's measure
    judge = Judge(deck, 3, po.space.nodes, "cpu")
    numbers = judge.judge([u0] + po.chain, [])
    assert numbers["ic_err"] < 1e-13
    assert numbers["res_setup"] < 1e-6


def _counted(fn):
    """The span counters that ``fn()`` moves under a profiler."""
    spans.fold(new_stats())
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    out = new_stats()
    spans.fold(out)
    return {k: out[k] for k in spans.COUNTERS if out[k]}


def test_p_transfer_bytes_are_the_shapes(tmp_path):
    """Per build the state's two injections, per cycle the prolongation
    and the restriction: float64 rows and int64 indices, from shapes;
    the h-level's transfers are not the p-level's."""
    s = _port(_deck(tmp_path))
    levels = build_hierarchy(s, min_elems=MIN_ELEMS)
    p, h = levels[1], levels[2]
    N, Nc, c, d = s.op.n_nodes, p.op.n_nodes, 4, 3
    Mp, Mr = p.masters.shape[1], p.restrict_idx.shape[1]
    assert (Mp, Mr) == (8, 64)
    inject = 8 * (Nc * c + Nc) + 8 * (Nc * d + Nc)
    cycle = 8 * (N * Mp * c + N * Mp) + 8 * (Nc * Mr * c + Nc * Mr)
    gen = torch.Generator().manual_seed(3)
    u = torch.rand((N, c), generator=gen, dtype=torch.float64)
    prev = torch.rand((N, d), generator=gen, dtype=torch.float64)
    fq = torch.zeros((s.space.n_elements, s.op.n_q, d), dtype=torch.float64)
    mask = torch.zeros((N, c), dtype=torch.bool)
    build = make_vcycle(levels)

    def one(cycles):
        apply = build(u, prev, fq, 10.0, 50.0, mask)
        for _ in range(cycles):
            apply(u)

    for cycles in (1, 3):
        got = _counted(lambda: one(cycles))
        assert got["gather_bytes_transfer_p"] == inject + cycles * cycle
        assert got["gather_calls_transfer_p"] == 2 + 2 * cycles
        assert got["gather_bytes_transfer"] > got["gather_bytes_transfer_p"]
    # each transfer alone, and the h-level's not counted as the p-level's
    assert _counted(lambda: prolong(p, u[:Nc]))[
        "gather_bytes_transfer_p"] == 8 * (N * Mp * c + N * Mp)
    assert _counted(lambda: restrict(p, u))[
        "gather_bytes_transfer_p"] == 8 * (Nc * Mr * c + Nc * Mr)
    only_h = _counted(lambda: (h.down(u[:Nc]), restrict(h, u[:Nc])))
    assert "gather_bytes_transfer_p" not in only_h
    assert only_h["gather_bytes_transfer"] > 0


@pytest.mark.parametrize("fn", [prolong, restrict])
def test_p_transfers_count_nothing_without_a_profiler(tmp_path, fn):
    s = _port(_deck(tmp_path))
    p = s.mg_levels[1]
    spans.fold(new_stats())
    fn(p, torch.ones((p.op.n_nodes if fn is prolong else s.op.n_nodes, 4),
                     dtype=torch.float64))
    assert all(v == 0 for v in spans._counts.values())
