"""The PyTorch package's CLI on the CPU in float64.

It reproduces the JAX package's golden outputs under the same numeric
diff (``tests/test_golden_apps.py::numdiff``, rtol 2e-3), the Kelly
deck's among them, and prints what the JAX package's CLI prints on
decks with SDIRK, pseudo-transient continuation, checkpoints, additive
Schwarz and Kelly adaptation; a checkpoint of an adapted forest
restarts in either package.  Its runs over N shards on the CPU
(``deck.prm N --device cpu``, ``_run_shards``) are in
``test_torch_cli_sharded.py`` (N shards against one device) and
``test_torch_cli_sharded_golden.py`` (the JAX package's multi-device
goldens and the restart across shard counts).
"""

import contextlib
import io
import os
import re

import pytest
import torch

from softx_2020_200_tpu_torch.apps.common import run_app
from tests.test_golden_apps import GOLDEN_DIR, numdiff

torch.set_num_threads(1)


def _run(dim, argv, tmp_path, monkeypatch, solver="gls"):
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_app(dim, argv, solver=solver)
    assert rc == 0
    return buf.getvalue()


@pytest.mark.parametrize("name", ["couette_gls", "mms_bdf2", "periodic_gls",
                                  "kelly_steady"])
def test_cli_reproduces_golden_output(name, tmp_path, monkeypatch):
    deck = os.path.join(GOLDEN_DIR, name + ".prm")
    out = _run(2, [deck, "--device", "cpu", "--dtype", "float64"],
               tmp_path, monkeypatch)
    with open(os.path.join(GOLDEN_DIR, name + ".output")) as fh:
        numdiff(out, fh.read())


@pytest.mark.parametrize("name", ["gd_cavity", "gd_mms_bdf2"])
def test_gd_cli_reproduces_golden_output(name, tmp_path, monkeypatch):
    """The grad-div Taylor-Hood app (``gd_navier_stokes_2d``): the steady
    cavity with wall forces, and the BDF2 MMS deck."""
    deck = os.path.join(GOLDEN_DIR, name + ".prm")
    out = _run(2, [deck, "--device", "cpu", "--dtype", "float64"],
               tmp_path, monkeypatch, solver="gd")
    with open(os.path.join(GOLDEN_DIR, name + ".output")) as fh:
        numdiff(out, fh.read())


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, name + ".prm")) as fh:
        return fh.read()


def test_cli_without_test_mode_reports_solver_counts(tmp_path, monkeypatch):
    """Outside ``subsection test`` the app says what ``auto`` resolves to
    (the Q2 lattice coarsens to a Q1 level) and prints the Newton summary
    with the host syncs per iteration."""
    text = _golden("periodic_gls")
    assert text.endswith("subsection test\n  set enable = true\nend\n")
    text = text[:-len("  set enable = true\nend\n")] + "end\n"
    deck = _write(tmp_path, "deck.prm", text)
    out = _run(2, [deck, "--device", "cpu", "--dtype", "float64"],
               tmp_path, monkeypatch)
    assert "preconditioner 'auto' resolves to gmg (2 levels)" in out
    summary = [ln for ln in out.splitlines()
               if ln.startswith("Newton summary: 1 solves")]
    assert len(summary) == 1
    assert "host syncs per Newton iteration" in summary[0]


def test_cli_bf16_jacobian_state_matches_jax(tmp_path, monkeypatch):
    """``jacobian state precision = bf16`` on the steady Couette deck of
    ``tests/test_pallas_kernel.py``: the port's CLI (CPU, float64 compute,
    the plain kernels on a bf16 state) takes the JAX solver's Newton
    iterations with ``enable_pallas(interpret=True,
    state_dtype=bfloat16)`` and its Krylov iterations within 1 per linear
    solve, and both meet that test's bar on the velocity L2 error."""
    import jax
    import jax.numpy as jnp

    from tests.test_gls_steady import BASE, COUETTE_BCS, make_solver
    text = BASE.format(nu=0.1, order=1, refine=2, precond="block_jacobi",
                       extra=COUETTE_BCS)
    head = "subsection linear solver\n"
    assert text.count(head) == 1
    text = text.replace(head, head + "  set jacobian state precision = bf16\n")
    deck = _write(tmp_path, "couette_bf16.prm", text)
    out = _run(2, [deck, "--device", "cpu", "--dtype", "float64"], tmp_path,
               monkeypatch)
    summary = re.search(r"Newton summary: 1 solves, (\d+) iterations, "
                        r"(\d+) linear iterations", out)
    l2 = re.findall(r"L2 error velocity : (\S+)", out)
    assert summary is not None and len(l2) == 1

    s = make_solver(refine=2, extra=COUETTE_BCS)
    s.op.enable_pallas(interpret=True, state_dtype=jnp.bfloat16)
    s._solve_jit = jax.jit(s._solve_impl)
    u, res = s.solve_steady(verbose=False)
    ev, _ = s.l2_errors(u)
    newton, krylov = int(summary.group(1)), int(summary.group(2))
    assert newton == int(res.n_iterations)
    assert abs(krylov - int(res.linear_iters)) <= newton
    assert ev < 1e-5 and float(l2[0]) < 1e-5


def _jax_cli(dim, deck, tmp_path, monkeypatch, solver="gls"):
    """The JAX package's CLI on ``deck`` in ``tmp_path``: its output."""
    from softx_2020_200_tpu.apps.common import run_app as jax_run_app
    kw = {}
    if solver == "gd":
        from softx_2020_200_tpu.solvers.gd import GDNavierStokesSolver
        kw["solver_cls"] = GDNavierStokesSolver
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_run_app(dim, [deck], **kw) == 0
    return buf.getvalue()


@pytest.mark.parametrize("section,edit", [
    ("non-linear solver", "  set solver = pseudo_transient\n"),
    ("linear solver", "  set preconditioner = additive_schwarz\n"),
], ids=["pseudo_transient", "additive_schwarz"])
def test_cli_solver_option_matches_jax(section, edit, tmp_path,
                                       monkeypatch):
    """The Couette golden deck with pseudo-transient continuation or
    additive Schwarz through the port's CLI (CPU, float64) prints what
    the JAX package's CLI prints on the same deck."""
    text = _golden("couette_gls")
    head = f"subsection {section}\n"
    assert text.count(head) == 1
    deck = _write(tmp_path, "deck.prm", text.replace(head, head + edit))
    (tmp_path / "jax").mkdir()
    want = _jax_cli(2, deck, tmp_path / "jax", monkeypatch)
    out = _run(2, [deck, "--device", "cpu", "--dtype", "float64"],
               tmp_path, monkeypatch)
    assert "L2 error velocity" in out
    numdiff(out, want, rtol=1e-6)


@pytest.mark.parametrize("old,new", [
    ("set method        = bdf2", "set method        = sdirk2"),
    ("subsection test\n", "subsection restart\n  set checkpoint = true\n"
     "  set filename = gd_restart\nend\nsubsection test\n"),
], ids=["sdirk", "checkpoint"])
def test_gd_cli_option_matches_jax(old, new, tmp_path, monkeypatch):
    """The GD golden MMS deck with SDIRK2, or writing a checkpoint every
    step, through the port's GD CLI (CPU, float64) prints what the JAX
    package's prints; the two checkpoints hold the same state, history
    and control."""
    import json

    import numpy as np
    text = _golden("gd_mms_bdf2")
    assert text.count(old) == 1
    deck = _write(tmp_path, "deck.prm", text.replace(old, new))
    (tmp_path / "jax").mkdir()
    want = _jax_cli(2, deck, tmp_path / "jax", monkeypatch, solver="gd")
    out = _run(2, [deck, "--device", "cpu", "--dtype", "float64"],
               tmp_path, monkeypatch, solver="gd")
    assert "L2 error velocity" in out
    numdiff(out, want, rtol=1e-6)
    if "checkpoint" in new:
        port = np.load(tmp_path / "gd_restart.npz")
        ref = np.load(tmp_path / "jax" / "gd_restart.npz")
        assert sorted(port.files) == sorted(ref.files)
        for key in ("u", "previous"):
            np.testing.assert_allclose(port[key], ref[key], rtol=0,
                                       atol=1e-9 * np.abs(ref[key]).max())
        assert int(port["n_dofs"]) == int(ref["n_dofs"])
        cp, cr = (json.loads(str(f["control"])) for f in (port, ref))
        assert cp.pop("cfl") == pytest.approx(cr.pop("cfl"), rel=1e-12)
        assert cp == cr


_KELLY = ("subsection test\n", "subsection mesh adaptation\n  set type = "
          "kelly\nend\nsubsection test\n")


# tests/test_gd_solver.py::test_gd_kelly_steady_cycles's deck: Poiseuille
# flow, which Q2-Q1 holds exactly on any mesh
_GD_POISEUILLE_KELLY = """
subsection mesh adaptation
  set type = kelly
  set fraction type = number
  set fraction refinement = 0.25
end
subsection boundary conditions
  set number = 4
""" + "".join(f"""  subsection bc {i}
    set id = {i}
    set type = function
    subsection u
      set Function expression = 4*y*(1-y)
    end
  end
""" for i in (0, 1)) + "".join(f"""  subsection bc {i}
    set id = {i}
    set type = noslip
  end
""" for i in (2, 3)) + """end
subsection analytical solution
  set enable = true
  subsection uvwp
    set Function expression = 4*y*(1-y); 0; -8*0.05*x
  end
end
subsection test
  set enable = true
end
"""


@pytest.mark.parametrize("name", ["steady_cycles", "transient",
                                  "checkpoint"])
def test_gd_cli_kelly_matches_jax(name, tmp_path, monkeypatch):
    """GD decks with Kelly adaptation through the port's GD CLI (CPU,
    float64) print what the JAX package's prints (analogues of
    ``tests/test_gd_solver.py::test_gd_kelly_*``): steady cycles on the
    Poiseuille channel of ``test_gd_kelly_steady_cycles``, the BDF2 MMS
    deck adapting every step, and the same writing its forest checkpoint
    every step, which both packages write alike."""
    import numpy as np
    if name == "steady_cycles":
        from tests.test_gd_solver import BASE
        text = BASE.format(nu=0.05, refine=2, extra=_GD_POISEUILLE_KELLY)
        head = "subsection simulation control\n"
        assert text.count(head) == 1
        text = text.replace(head, head + "  set number mesh adapt = 2\n"
                            "  set output frequency = 0\n")
    else:
        text = _golden("gd_mms_bdf2").replace(*_KELLY)
    if name == "checkpoint":
        text = text.replace("subsection test\n", "subsection restart\n  set "
                            "checkpoint = true\n  set filename = gd_forest\n"
                            "end\nsubsection test\n")
    deck = _write(tmp_path, "deck.prm", text)
    (tmp_path / "jax").mkdir()
    want = _jax_cli(2, deck, tmp_path / "jax", monkeypatch, solver="gd")
    out = _run(2, [deck, "--device", "cpu", "--dtype", "float64"],
               tmp_path, monkeypatch, solver="gd")
    assert out.count("L2 error velocity") >= 3
    numdiff(out, want, rtol=1e-6)
    if name == "checkpoint":
        port = np.load(tmp_path / "gd_forest.npz")
        ref = np.load(tmp_path / "jax" / "gd_forest.npz")
        assert sorted(port.files) == sorted(ref.files)
        for key in ("forest_leaves", "base_cells", "n_dofs"):
            np.testing.assert_array_equal(port[key], ref[key])
        np.testing.assert_allclose(port["u"], ref["u"], rtol=0,
                                   atol=1e-9 * np.abs(ref["u"]).max())


def _forest_solver(pkg, outdir, t_end, checkpoint, restart):
    """The forest restart deck of ``tests/test_restart_forest.py`` (Kelly
    every 3 steps, a checkpoint every 4) in the JAX package or the
    port."""
    from tests.test_restart_forest import KELLY_DECK
    text = KELLY_DECK.format(t_end=t_end, outdir=outdir, fname="ck",
                             checkpoint=str(checkpoint).lower(),
                             restart=str(restart).lower())
    if pkg == "jax":
        from softx_2020_200_tpu.core.parameters import SimulationParameters
        from softx_2020_200_tpu.solvers.base import GLSNavierStokesSolver
        return GLSNavierStokesSolver(SimulationParameters.from_text(text,
                                                                    dim=2))
    from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
    from softx_2020_200_tpu_torch.solvers.base import GLSNavierStokesSolver
    return GLSNavierStokesSolver(SimulationParameters.from_text(text, dim=2),
                                 device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_forest_checkpoint_restarts_across_packages(writer, reader,
                                                    tmp_path):
    """A checkpoint of an adapted forest (4 steps, Kelly after step 3)
    written by one package restarts in the other: the restarted run's
    last 4 steps (another adaptation after step 6) end on the same
    leaves and state as the writer's own restart."""
    import numpy as np
    out = {}
    for who in (writer, reader):
        d = tmp_path / who
        d.mkdir()
        if who == writer:
            _forest_solver(who, d, 0.2, True, False).solve()
        else:
            import shutil
            shutil.copy(tmp_path / writer / "ck.npz", d / "ck.npz")
        s = _forest_solver(who, d, 0.4, False, True)
        u = s.solve()
        out[who] = (np.asarray(u.numpy() if torch.is_tensor(u) else u),
                    [set(x) for x in s.forest.leaves])
    (ua, la), (ub, lb) = out[writer], out[reader]
    assert lb == la
    np.testing.assert_allclose(ub, ua, rtol=0, atol=1e-9 * np.abs(ua).max())


def test_cli_device_and_device_count(tmp_path, monkeypatch):
    """N shards on ``--device cpu`` print the golden; N on ``--device
    cuda`` need N cards; one device on CUDA needs CUDA."""
    deck = os.path.join(GOLDEN_DIR, "couette_gls.prm")
    out = _run(2, [deck, "2", "--device", "cpu", "--dtype", "float64"],
               tmp_path, monkeypatch)
    with open(os.path.join(GOLDEN_DIR, "couette_gls.output")) as fh:
        numdiff(out, fh.read())
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="need 2 devices"):
            _run(2, [deck, "2"], tmp_path, monkeypatch)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _run(2, [deck], tmp_path, monkeypatch)


# lines the port's CLI prints outside test mode that the JAX package's
# does not
_PORT_ONLY = ("linear solver: ", "Newton summary: ")


def _run_shards(name, n, tmp_path, monkeypatch, solver="gls"):
    """The golden deck ``name`` over ``n`` shards on the CPU in float64
    (``n`` = 1: one device): its output without the port-only lines."""
    deck = os.path.join(GOLDEN_DIR, name + ".prm")
    argv = [deck] + ([str(n)] if n > 1 else []) + ["--device", "cpu",
                                                   "--dtype", "float64"]
    out = _run(2, argv, tmp_path, monkeypatch, solver=solver)
    return "\n".join(ln for ln in out.splitlines()
                     if not ln.startswith(_PORT_ONLY))
