"""BASELINE #2's convergence ladders through the PyTorch package
(``scripts/run_convergence_torch.py``) against the JAX package on the
same decks (``scripts/jax_convergence_references.py``, the decks of
``tests/test_mms_convergence.py`` and ``tests/test_gd_solver.py``), on
the CPU in float64: the L2 errors per level within ``L2_REL`` of each
other and the JAX tests' own bounds on the rates and the torque.

The fast tier takes one comparison per ladder at a reduced size: the Q1
MMS over one uniform cycle (8^2, 16^2), the Q2 MMS at its first level
(4^2), grad-div at the JAX test's sizes (4^2, 8^2), Taylor-Couette at
refinement 1 with its torques, and one time step of dt 0.1 of each
transient scheme at 2^2 (BDF3 through ``history_from_exact``), against
the JAX package's rows recorded inline (``JAX_REDUCED``: compiling the
JAX solver takes about 10 s a case); the slow tier recomputes them.  The
JAX tests' full sizes (``slow``, both packages run) take 20 s to 3
minutes each on the port's CPU path.
Also here: ``run_transient(history_from_exact=True)`` itself in both
packages, the driver's copies of the decks, and that the driver imports
no JAX and needs CUDA unless ``--device cpu``.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
sys.path.insert(0, SCRIPTS)

import jax_convergence_references as ref  # noqa: E402
import run_convergence_torch as conv  # noqa: E402

torch.set_num_threads(1)
L2_REL = 1e-6        # each level's L2 error, port against JAX, f64
CPU = ["--device", "cpu", "--dtype", "float64"]

# (ladder, driver flags, keywords of the driver's levels()): the fast
# tier's reduced ladders and the JAX tests' own sizes
FAST = [("q1", ["--max-q1", "0"], dict(cycles=1)),
        ("q2", ["--max-q2", "0"], dict(cycles=0)),
        ("gd", ["--max-gd", "8"], {}),
        ("tc", ["--max-tc", "1", "--tc-forest", ""], dict(tc_jax=(1,)))]
FAST += [(name, ["--time-refines", "1", "--min-dt", "0.1"], dict(t_end=0.1))
         for name in conv.TEMPORAL]
FULL = [("q1", ["--max-q1", "0"], {}),
        ("q2", ["--max-q2", "0"], {}),
        ("tc", ["--max-tc", "1", "--tc-forest", ""], {})]
FULL += [(name, ["--time-refines", "2", "--min-dt", "0.05"], {})
         for name in conv.TEMPORAL]


# The JAX package's rows of FAST's ladders
# (scripts/jax_convergence_references.py, CPU, float64): (label, route,
# cells, DoF, L2 velocity, L2 pressure[, torque on the inner wall, on the
# outer wall])
JAX_REDUCED = {
    "q1": [
        ("8^2", "cycle 0", 64, 243, 0.02968924758229757, 0.10779366054711245),
        ("16^2", "cycle 1", 256, 867, 0.0076183194346176875,
         0.03544663572639125),
    ],
    "q2": [
        ("4^2", "cycle 0", 16, 243, 0.01335249829233208, 0.05864575176592663),
    ],
    "gd": [
        ("4^2", "deck", 16, 187, 0.012211588646979377, 0.039988551931564316),
        ("8^2", "deck", 64, 659, 0.0016187890125677075, 0.005325372519024448),
    ],
    "tc": [
        ("r1", "deck", 48, 720, 0.00406263320251827, 0.0005664827214228494,
         -0.7207287403297864, 0.8131372843717537),
    ],
    "bdf1": [("dt 0.1 @ 2^2", "run_transient", 4, 75, 0.00044089239355718876,
              0.004738005298547354)],
    "bdf2": [("dt 0.1 @ 2^2", "run_transient", 4, 75, 0.00011386617821491156,
              0.00023238191257256584)],
    "bdf3": [("dt 0.1 @ 2^2", "run_transient", 4, 75, 1.579719838522699e-06,
              2.6332394060546666e-05)],
    "sdirk2": [("dt 0.1 @ 2^2", "run_transient", 4, 75,
                2.9818400518410502e-05, 0.0039123035740149005)],
    "sdirk3": [("dt 0.1 @ 2^2", "run_transient", 4, 75,
                1.4114673777634964e-05, 0.00236187440756005)],
}
RECORD_KEYS = ("label", "route", "cells", "dofs", "error_velocity",
               "error_pressure", "torque_inner", "torque_outer")


def recorded(name: str) -> list[dict]:
    return [dict(zip(RECORD_KEYS, row)) for row in JAX_REDUCED[name]]


def ladder(name: str, flags: list, reduced: dict, package=conv) -> list:
    """One package's rows of a ladder (``ref``: the JAX package's)."""
    args = conv.parse_args(["--ladders", name] + flags + CPU)
    todo = conv.levels(name, args, **reduced)
    if package is ref:
        return ref.run_ladder(name, args, todo=todo)
    return conv.run_ladder(name, args, emit=lambda s: None, todo=todo)


def check_rows(port: list, jax: list) -> None:
    assert [(r["label"], r["route"]) for r in port] == [
        (r["label"], r["route"]) for r in jax]
    for p, j in zip(port, jax):
        assert (p["cells"], p["dofs"]) == (j["cells"], j["dofs"])
        for key in ("error_velocity", "error_pressure"):
            assert p[key] == pytest.approx(j[key], rel=L2_REL), (
                p["label"], key)
        assert p["above_tolerance"] == 0
        if "torque_inner" in j:
            for key in ("torque_inner", "torque_outer"):
                assert p[key] == pytest.approx(j[key], rel=L2_REL)


def in_bounds(value: float, bounds) -> bool:
    low, high = bounds
    return (low is None or value > low) and (high is None or value < high)


def check_bounds(name: str, rows: list) -> None:
    """The JAX tests' bounds on the last rate of the ladder (velocity;
    the Q2 pressure too), and their absolute bounds."""
    last = [r for r in rows if r.get("rate_velocity") is not None]
    if name in conv.RATE_BOUNDS and last:
        assert in_bounds(last[-1]["rate_velocity"], conv.RATE_BOUNDS[name])
        if name == "q2":
            assert in_bounds(last[-1]["rate_pressure"],
                             conv.RATE_BOUNDS["q2_pressure"])
    if name == "tc" and rows[-1]["label"] == "r2":
        # tests/test_mms_convergence.py::test_taylor_couette_q2 and
        # tests/test_postprocessing.py::test_taylor_couette_torque
        r2 = rows[-1]
        assert r2["error_velocity"] < 2e-3
        assert r2["torque_inner"] == pytest.approx(conv.TC_TORQUE,
                                                   rel=7e-2)
        assert r2["torque_outer"] == pytest.approx(-r2["torque_inner"],
                                                   rel=1.2e-1)
    if name == "sdirk2" and len(rows) > 1:
        assert rows[-1]["error_velocity"] < 5e-4


@pytest.mark.parametrize("name,flags,reduced", FAST,
                         ids=[n for n, _, _ in FAST])
def test_ladder_matches_jax_reduced(name, flags, reduced):
    port = ladder(name, flags, reduced)
    check_rows(port, recorded(name))
    check_bounds(name, port)


@pytest.mark.slow
@pytest.mark.parametrize("name,flags,reduced", FAST,
                         ids=[n for n, _, _ in FAST])
def test_recorded_jax_rows_are_the_jax_packages(name, flags, reduced):
    jax = ladder(name, flags, reduced, package=ref)
    want = recorded(name)
    assert [(r["label"], r["route"], r["cells"], r["dofs"]) for r in jax] == [
        (r["label"], r["route"], r["cells"], r["dofs"]) for r in want]
    for j, w in zip(jax, want):
        for key in RECORD_KEYS[4:]:
            if key in w:
                assert j[key] == pytest.approx(w[key], rel=1e-9), key


@pytest.mark.slow
@pytest.mark.parametrize("name,flags,reduced", FULL,
                         ids=[n for n, _, _ in FULL])
def test_ladder_matches_jax_at_the_jax_tests_sizes(name, flags, reduced):
    port = ladder(name, flags, reduced)
    jax = ladder(name, flags, reduced, package=ref)
    check_rows(port, jax)
    check_bounds(name, port)
    check_bounds(name, jax)
    if name == "sdirk3":
        # tests/test_sdirk_l2proj.py::test_sdirk3_beats_sdirk2 at dt 0.1
        args = conv.parse_args(["--ladders", "sdirk2", "--time-refines",
                                "2", "--min-dt", "0.1"] + CPU)
        s2 = conv.run_ladder("sdirk2", args, emit=lambda s: None)
        assert port[0]["error_velocity"] < 0.5 * s2[0]["error_velocity"]


# ----------------------------------------------------------------------
# history_from_exact
# ----------------------------------------------------------------------
class _Stop(Exception):
    pass


def _first_step_history(solver_cls, prm, to_np):
    """(previous, dts) of the first BDF step of ``run_transient`` with
    ``history_from_exact``, the step itself not taken."""
    s = solver_cls(prm) if to_np is np.asarray else solver_cls(
        prm, device="cpu", dtype=torch.float64)
    seen = {}

    def step(u, previous, t, dts, order, verbose=None):
        seen.update(previous=[to_np(p) for p in previous],
                    dts=list(np.asarray(dts)), order=order, t=t)
        raise _Stop

    s.solve_transient_step = step
    with pytest.raises(_Stop):
        s.run_transient(verbose=False, history_from_exact=True)
    return s, seen


def _bdf3_prm(package, analytical: bool = True):
    deck = conv.TRANSIENT_MMS_DECK.format(method="bdf3", dt=0.1, tend=0.5,
                                          refine=1)
    if not analytical:
        head, rest = deck.split("subsection analytical solution")
        deck = (head + rest.split("end\nend\n", 1)[1]).replace(
            "subsection source term\n  set enable = true",
            "subsection source term\n  set enable = false")
    return package.SimulationParameters.from_text(deck, dim=2)


def test_history_from_exact_seeds_the_exact_solution():
    """The history is the analytical solution at t - dt and t - 2 dt on
    the space's nodes, the dt history holds the target order's steps and
    the first step runs at full order, in both packages; without an
    analytical solution it raises."""
    from softx_2020_200_tpu.core import parameters as jp
    from softx_2020_200_tpu.solvers.base import \
        GLSNavierStokesSolver as JaxSolver
    from softx_2020_200_tpu_torch.core import parameters as tp
    from softx_2020_200_tpu_torch.solvers.base import \
        GLSNavierStokesSolver as TorchSolver
    port, p = _first_step_history(TorchSolver, _bdf3_prm(tp),
                                  lambda t: t.numpy())
    _, j = _first_step_history(JaxSolver, _bdf3_prm(jp), np.asarray)
    nodes = np.asarray(port.space.nodes)
    x, y = nodes[:, 0], nodes[:, 1]
    for i, back in ((1, -0.1), (2, -0.2)):
        want = np.stack([math.exp(-back) * y * y, 0 * x,
                         math.exp(-back) * x], axis=1)
        np.testing.assert_allclose(p["previous"][i], want, rtol=1e-14,
                                   atol=1e-14)
        np.testing.assert_allclose(p["previous"][i], j["previous"][i],
                                   rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(p["previous"][0], j["previous"][0],
                               rtol=1e-14, atol=1e-14)
    # the pre-filled target order's steps and the first step's own
    assert p["dts"] == j["dts"] == [0.1] * 4
    assert p["order"] == j["order"] == 3
    assert p["t"] == pytest.approx(0.1) and j["t"] == pytest.approx(0.1)
    for cls, pkg in ((TorchSolver, tp), (JaxSolver, jp)):
        prm = _bdf3_prm(pkg, analytical=False)
        s = (cls(prm, device="cpu", dtype=torch.float64)
             if cls is TorchSolver else cls(prm))
        with pytest.raises(ValueError, match="analytical solution"):
            s.run_transient(verbose=False, history_from_exact=True)


# ----------------------------------------------------------------------
# the driver
# ----------------------------------------------------------------------
def test_driver_decks_are_the_jax_tests_decks():
    from tests.test_gd_solver import BASE
    from tests.test_mms_convergence import (MMS_DECK, TC_DECK,
                                            TRANSIENT_MMS_DECK)
    assert conv.MMS_DECK == MMS_DECK
    assert conv.TRANSIENT_MMS_DECK == TRANSIENT_MMS_DECK
    assert conv.TC_DECK == TC_DECK
    assert conv.GD_BASE == BASE
    assert conv.GD_MMS_EXTRA == ref.gd_mms_extra()


def test_driver_imports_no_jax_and_needs_cuda():
    """The driver imports neither jax nor the JAX package, and its
    default ``--device cuda`` fails where CUDA is not available."""
    code = f"""
import sys
sys.path.insert(0, {SCRIPTS!r})
import run_convergence_torch as mod
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
       or m.split(".")[0] == "softx_2020_200_tpu"]
assert not bad, bad
import torch
assert not torch.cuda.is_available()
assert mod.main([]) == 1
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    assert "CUDA is not available" in out.stderr
