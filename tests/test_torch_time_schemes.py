"""SDIRK, pseudo-transient continuation and checkpoint/restart in the
PyTorch package, against the JAX package on the CPU in float64.

- SDIRK: SDIRK2 is second order and SDIRK3 beats SDIRK2 (the analogues
  of ``tests/test_sdirk_l2proj.py``); one SDIRK2 and one SDIRK3 step of
  the GLS engine, and one SDIRK2 step of the GD engine, within 1e-10 of
  scale of the JAX package's state, Newton iterations equal stage by
  stage; ``tests/golden/sdirk_np8.prm`` through both packages' CLIs, on
  one device, with the same output, equal Newton counts and per-step L2
  errors within 1e-10 relative; the GD analogue of
  ``tests/test_gd_solver.py::test_gd_sdirk_step``.
- Pseudo-transient continuation (GLS): on the deck of
  ``tests/test_slip_cfl.py::test_ptc_matches_newton_on_steady_flow`` it
  reaches plain Newton's solution, and takes the JAX package's
  pseudo-steps with its Krylov iterations within 1 per step.
- Checkpoint/restart: the analogues of
  ``tests/test_postprocessing.py::test_checkpoint_restart_roundtrip`` and
  ``tests/test_gd_solver.py::test_gd_checkpoint_restart``; the port's CLI
  reproduces ``tests/golden/restart_adaptive_b.output`` after
  ``restart_adaptive_a.prm`` (CFL-adaptive dt), from its own checkpoint
  and from the JAX package's; the JAX package continues from the port's
  checkpoint to the port's state.

Where Dirichlet data on the whole boundary leave the pressure defined up
to a constant, the nodal pressure mean is removed before comparing
states (``tests/test_torch_solver.py::_rel_state``).
"""

import contextlib
import inspect
import io
import os

import numpy as np
import pytest
import torch

import tests.test_slip_cfl as slip_cfl
from softx_2020_200_tpu.apps.common import run_app as jax_run_app
from softx_2020_200_tpu.core.parameters import \
    SimulationParameters as JaxParameters
from softx_2020_200_tpu.solvers.base import \
    GLSNavierStokesSolver as JaxSolver
from softx_2020_200_tpu.solvers.gd import GDNavierStokesSolver as JaxGD
from softx_2020_200_tpu_torch.apps.common import run_app
from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
from softx_2020_200_tpu_torch.solvers.base import GLSNavierStokesSolver
from softx_2020_200_tpu_torch.solvers.gd import GDNavierStokesSolver
from tests.test_gd_solver import GD_TRANSIENT_DECK
from tests.test_golden_apps import GOLDEN_DIR, numdiff
from tests.test_mms_convergence import TRANSIENT_MMS_DECK
from tests.test_torch_solver import _rel, _rel_state

torch.set_num_threads(1)

CPU = dict(device="cpu", dtype=torch.float64)


def _mms(method, dt, tend, tmp_path, extra="", precond=None):
    """The transient Q2 MMS deck (4x4 cells), output to ``tmp_path``,
    with its own preconditioner ('auto': multigrid) or ``precond``."""
    text = TRANSIENT_MMS_DECK.format(method=method, dt=dt, tend=tend,
                                     refine=2)
    if precond is not None:
        text = text.replace("subsection linear solver\n",
                            "subsection linear solver\n"
                            f"  set preconditioner = {precond}\n", 1)
    return text.replace("subsection simulation control\n",
                        "subsection simulation control\n"
                        f"  set output path = {tmp_path}/\n"
                        "  set output frequency = 0\n", 1) + extra


def _port(text, dim=2, cls=GLSNavierStokesSolver):
    return cls(SimulationParameters.from_text(text, dim=dim), **CPU)


def _jax(text, dim=2, cls=JaxSolver):
    return cls(JaxParameters.from_text(text, dim=dim))


def _count_solves(solver):
    """Record (Newton, Krylov) of every nonlinear solve of ``solver``."""
    counts = []
    newton = solver._newton

    def counted(*args, **kw):
        res = newton(*args, **kw)
        counts.append((int(res.n_iterations), int(res.linear_iters)))
        return res

    solver._newton = counted
    return counts


def _same_counts(port, ref):
    """Equal Newton iterations, Krylov within 1 per linear solve."""
    assert len(port) == len(ref)
    for (n_p, l_p), (n_r, l_r) in zip(port, ref):
        assert n_p == n_r
        assert abs(l_p - l_r) <= max(n_r, 1)


# ----------------------------------------------------------------------
# SDIRK
# ----------------------------------------------------------------------
def _sdirk_error(method, dt, tmp_path):
    """The velocity L2 error at t = 0.2 (the JAX package's tests run to
    0.5; the space-exact field leaves only the temporal error either
    way), with block-Jacobi."""
    s = _port(_mms(method, dt, 0.2, tmp_path, precond="block_jacobi"))
    u = s.run_transient(verbose=False)
    return s.l2_errors(u, t=s.control.time)[0]


def test_sdirk2_second_order(tmp_path):
    e1 = _sdirk_error("sdirk2", 0.1, tmp_path)
    e2 = _sdirk_error("sdirk2", 0.05, tmp_path)
    rate = np.log2(e1 / e2)
    assert 1.6 < rate < 3.6, f"SDIRK2 rate {rate} ({e1}, {e2})"
    assert e2 < 5e-4


def test_sdirk3_beats_sdirk2(tmp_path):
    e2 = _sdirk_error("sdirk2", 0.1, tmp_path)
    e3 = _sdirk_error("sdirk3", 0.1, tmp_path)
    assert e3 < 0.5 * e2, f"SDIRK3 {e3} should beat SDIRK2 {e2}"


@pytest.mark.parametrize("method", ["sdirk2", "sdirk3"])
def test_sdirk_step_matches_jax(method, tmp_path):
    """One step: every stage's Newton and Krylov counts, and the state."""
    text = _mms(method, 0.1, 0.1, tmp_path)
    ja, po = _jax(text), _port(text)
    ca, cp = _count_solves(ja), _count_solves(po)
    ua = ja.run_transient(verbose=False)
    up = po.run_transient(verbose=False)
    assert len(cp) == int(method[-1])
    _same_counts(cp, ca)
    assert _rel_state(up, ua) < 1e-10


def test_sdirk_np8_deck_matches_jax(tmp_path, monkeypatch):
    """``tests/golden/sdirk_np8.prm`` (SDIRK2, time-dependent boundary
    values) on one device through both CLIs, then through both solvers:
    equal Newton counts and L2 errors within 1e-10 at every step."""
    deck = os.path.join(GOLDEN_DIR, "sdirk_np8.prm")
    monkeypatch.chdir(tmp_path)
    outs = []
    for run, argv in ((run_app, [deck, "--device", "cpu", "--dtype",
                                 "float64"]), (jax_run_app, [deck])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert run(2, argv) == 0
        outs.append(buf.getvalue())
    assert outs[0].count("L2 error velocity") == 4
    numdiff(outs[0], outs[1], rtol=1e-6)

    with open(deck) as fh:
        text = fh.read()
    runs = []
    for solver in (_port(text), _jax(text)):
        counts = _count_solves(solver)
        l2 = []
        solver.solve(on_cycle=lambda s, u, t: l2.append(s.l2_errors(u, t)))
        runs.append((counts, np.array(l2)))
    (cp, lp), (ca, la) = runs
    assert len(cp) == 8
    _same_counts(cp, ca)
    assert lp.shape == la.shape == (4, 2)
    assert _rel(lp[:, 0], la[:, 0]) < 1e-10


def _gd_deck(method, dt, tend, tmp_path, checkpoint="false",
             restart="false"):
    return GD_TRANSIENT_DECK.format(method=method, dt=dt, tend=tend,
                                    outdir=tmp_path, checkpoint=checkpoint,
                                    restart=restart)


def test_gd_sdirk_step(tmp_path):
    """SDIRK22 through the GD stage sequence: the MMS error at t = 0.2
    (``tests/test_gd_solver.py::test_gd_sdirk_step``)."""
    s = _port(_gd_deck("sdirk2", 0.05, 0.2, tmp_path),
              cls=GDNavierStokesSolver)
    x = s.solve()
    ev, _ = s.l2_errors(x, t=0.2)
    assert ev < 2e-4, f"GD SDIRK22 MMS error {ev}"


def test_gd_sdirk_step_matches_jax(tmp_path):
    """One GD SDIRK2 step: each stage's counts and the mixed state."""
    text = _gd_deck("sdirk2", 0.05, 0.05, tmp_path)
    ja = _jax(text, cls=JaxGD)
    po = _port(text, cls=GDNavierStokesSolver)
    ca, cp = _count_solves(ja), _count_solves(po)
    xa, xp = ja.solve(), po.solve()
    assert len(cp) == 2
    _same_counts(cp, ca)
    nv = po.op.Nv * po.dim
    assert _rel(np.asarray(xp)[:nv], np.asarray(xa)[:nv]) < 1e-10
    pa, pp = np.asarray(xa)[nv:], np.asarray(xp)[nv:]
    assert _rel(pp - pp.mean(), pa - pa.mean()) < 1e-10


# ----------------------------------------------------------------------
# pseudo-transient continuation
# ----------------------------------------------------------------------
def _ptc_deck(solver):
    src = inspect.getsource(slip_cfl.test_ptc_matches_newton_on_steady_flow)
    return src.split('deck = """')[1].split('"""')[0].format(solver=solver)


def test_ptc_matches_newton_on_steady_flow():
    """PTC reaches plain Newton's steady solution (the port alone)."""
    un, _ = _port(_ptc_deck("newton")).solve_steady(verbose=False)
    sp = _port(_ptc_deck("pseudo_transient"))
    up, res = sp.solve_steady(verbose=False)
    h = res.res_history[np.isfinite(res.res_history)]
    assert len(res.res_history) == sp.prm.nonlinear_solver.ptc_max_steps + 1
    assert h[-1] < 1e-10, f"PTC did not converge: {h[-5:]}"
    assert np.abs(un.numpy() - up.numpy()).max() < 1e-8
    assert sp.stats["newton_solves"] == 1
    assert sp.stats["newton_iterations"] == res.n_iterations


def test_ptc_matches_jax():
    """The same pseudo-steps as the JAX package, Krylov iterations within
    1 per step, the same steady residuals and solution."""
    ja, po = _jax(_ptc_deck("pseudo_transient")), \
        _port(_ptc_deck("pseudo_transient"))
    ra = ja.solve_steady_ptc(ja.initial_condition(), verbose=False)
    rp = po.solve_steady_ptc(po.initial_condition(), verbose=False)
    k = int(ra.n_iterations)
    assert rp.n_iterations == k > 3
    assert abs(rp.linear_iters - int(ra.linear_iters)) <= k
    np.testing.assert_allclose(rp.res_history[:k + 1],
                               np.asarray(ra.res_history)[:k + 1],
                               rtol=1e-6, atol=1e-12)
    assert np.abs(rp.u.numpy() - np.asarray(ra.u)).max() < 1e-8


# ----------------------------------------------------------------------
# checkpoint / restart
# ----------------------------------------------------------------------
def test_checkpoint_restart_roundtrip(tmp_path):
    """A run interrupted at t = 0.2 and resumed from its checkpoint ends
    where the uninterrupted BDF2 run ends."""
    extra = ("subsection restart\n  set checkpoint = true\n"
             "  set frequency = 2\n  set filename = restart_test\nend\n")
    text = _mms("bdf2", 0.1, 0.4, tmp_path, extra, precond="block_jacobi")
    u_full = _port(text).run_transient(verbose=False)
    _port(text.replace("set time end = 0.4", "set time end = 0.2")
          ).run_transient(verbose=False)
    assert os.path.exists(tmp_path / "restart_test.npz")
    s3 = _port(text.replace("set checkpoint = true",
                            "set checkpoint = true\n  set restart = true"))
    u_resumed = s3.run_transient(verbose=False)
    assert s3.control.time == pytest.approx(0.4)
    np.testing.assert_allclose(u_resumed.numpy(), u_full.numpy(),
                               atol=1e-10)


def test_gd_checkpoint_restart(tmp_path):
    """The GD engine's restart continues to the uninterrupted run."""
    x_full = _port(_gd_deck("bdf2", 0.05, 0.2, tmp_path),
                   cls=GDNavierStokesSolver).solve()
    _port(_gd_deck("bdf2", 0.05, 0.1, tmp_path, checkpoint="true"),
          cls=GDNavierStokesSolver).solve()
    x2 = _port(_gd_deck("bdf2", 0.05, 0.2, tmp_path, checkpoint="true",
                        restart="true"), cls=GDNavierStokesSolver).solve()
    np.testing.assert_allclose(x2.numpy(), x_full.numpy(), atol=1e-9)


# lines the port's CLI prints outside test mode that the JAX package's
# does not
_PORT_ONLY = ("linear solver: ", "Newton summary: ")


def _port_cli(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_app(2, [os.path.join(GOLDEN_DIR, name + ".prm"),
                         "--device", "cpu", "--dtype", "float64"])
    assert rc == 0
    return "\n".join(ln for ln in buf.getvalue().splitlines()
                     if not ln.startswith(_PORT_ONLY))


def _jax_cli(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_run_app(2, [os.path.join(GOLDEN_DIR, name + ".prm")]) == 0
    return buf.getvalue()


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, name + ".output")) as fh:
        return fh.read()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cli_restart_adaptive_golden(writer, tmp_path, monkeypatch):
    """Leg a (CFL-adaptive dt, a checkpoint every 2 steps) through the
    ``writer`` package's CLI, then leg b through the port's: the golden
    output of the restarted leg."""
    first = _port_cli if writer == "port" else _jax_cli
    first("restart_adaptive_a", tmp_path, monkeypatch)
    assert os.path.exists(tmp_path / "restart_adaptive.npz")
    out = _port_cli("restart_adaptive_b", tmp_path, monkeypatch)
    numdiff(out, _golden("restart_adaptive_b"))


def test_jax_continues_from_port_checkpoint(tmp_path, monkeypatch):
    """The JAX package's ``read_checkpoint`` takes the port's checkpoint
    (float64) and continues leg b to the state the port reaches from it."""
    _port_cli("restart_adaptive_a", tmp_path, monkeypatch)
    with open(os.path.join(GOLDEN_DIR, "restart_adaptive_b.prm")) as fh:
        text = fh.read()
    ja, po = _jax(text), _port(text)
    ua = ja.run_transient(verbose=False)
    up = po.run_transient(verbose=False)
    assert ja.control.iteration == po.control.iteration == 8
    assert ja.control.time == pytest.approx(po.control.time, rel=1e-14)
    assert _rel_state(up, ua) < 1e-10
