"""The plain float64 reference against the solver's CPU path in float64:
the same mesh, the same Dirichlet rows, the same initial field and the
same GLS-BDF2 residual at random states, on a tiny lattice and a tiny
cylinder mesh; the reference imports nothing of the solver."""

import ast
import os

import numpy as np
import pytest
import torch

from benchtools import ROOT, TINY
from benchmark import traffic
from benchmark.reference.check import Judge, round_to_tf32, schedule
from benchmark.reference.gls import bdf_weights


def _solver_and_judge(name, seed=2 ** 31 + 5):
    from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
    from softx_2020_200_tpu_torch.solvers.base import GLSNavierStokesSolver
    spec = TINY[name]
    cell = traffic.load_cell(spec["config"] + (
        ".r5" if "cylinder" in name else ".n96"))
    cell["deck"] = spec["deck"]
    deck = traffic.deck_for(cell, seed)
    dim = int(cell["config_data"]["dim"])
    prm = SimulationParameters.from_text(traffic.render(deck), dim)
    s = GLSNavierStokesSolver(prm, device="cpu", dtype=torch.float64)
    return s, Judge(deck, dim, s.space.nodes, "cpu"), dim


@pytest.mark.parametrize("name", sorted(TINY))
def test_residual_matches_the_solver(name):
    s, judge, dim = _solver_and_judge(name)
    gen = torch.Generator().manual_seed(11)
    u0 = s.initial_condition()
    assert judge.ic_err(u0) < 1e-13
    assert torch.equal(judge.mask[judge.perm], s.bh.mask)
    dt = s.prm.simulation_control.dt
    for k, dts in ((1, [0.4 * dt]), (2, [dt, 0.6 * dt]), (2, [dt, dt])):
        hist = [u0 + 0.05 * torch.randn(u0.shape, generator=gen,
                                        dtype=u0.dtype) for _ in range(k)]
        new = u0 + 0.05 * torch.randn(u0.shape, generator=gen,
                                      dtype=u0.dtype)
        alpha = bdf_weights(dts)
        combo = sum(float(a) * h[:, :dim] for a, h in zip(alpha[1:], hist))
        residual = s._make_problem(combo, 0.0, float(alpha[0]),
                                   1.0 / dts[0])[1]
        want = residual(new)
        got = judge.residual(judge.ref_order(new), judge.ref_order(
            torch.cat([combo, torch.zeros_like(new[:, dim:])], 1))[:, :dim],
            float(alpha[0]), 1.0 / dts[0])
        got[judge.mask] = 0.0
        scale = float(want.abs().max())
        assert float((got[judge.perm] - want).abs().max()) < 1e-11 * scale
        norm = float(torch.linalg.vector_norm(want))
        assert abs(judge.res(new, hist, dts) - norm) < 1e-11 * norm


def test_schedule_follows_the_start_up():
    cell = traffic.load_cell("tgv_re1600_q1.n96")
    steps, dt = schedule(cell["config_data"]["deck"])
    assert dt == 0.02
    assert [k for k, _ in steps] == [1, 2, 2]
    np.testing.assert_allclose(steps[0][1], [0.008])
    np.testing.assert_allclose(steps[1][1], [0.012, 0.008])
    np.testing.assert_allclose(steps[2][1], [0.02, 0.012])


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -10), 3.14159265], dtype=torch.float32)
    y = round_to_tf32(x)
    assert y.tolist()[:4] == [1.0, 1.0, 1.0 + 2 ** -9, -(1.0 + 2 ** -10)]
    assert abs(float(y[4]) / 3.14159265 - 1) < 2 ** -11


def test_reference_imports_nothing_of_the_solver():
    ref = os.path.join(ROOT, "benchmark", "reference")
    for f in os.listdir(ref):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(ref, f)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] in ("numpy", "torch", "scipy",
                                           "math", "itertools",
                                           "dataclasses", "__future__"), n
