"""The PyTorch package's validation drivers (``scripts/run_tgv_torch.py``,
``scripts/run_cylinder_torch.py``, ``scripts/run_cavity_torch.py``) on
the CPU in float64, each held to the JAX package's solver on the same
overrides, built as the JAX scripts (``scripts/run_tgv.py``,
``run_cylinder.py``, ``run_cavity.py``) build it: their deck edits on
``SimulationParameters``, ``GLSNavierStokesSolver`` and
``run_transient(on_step=...)`` or ``solve_steady``
(``scripts/jax_driver_references.py``), at small sizes: the TGV at 8^3
for 3 steps, the Q2 cylinder at refinement 0 for 4 steps with Kelly
every 2, the Q2 cavity at 8^2.  The drivers' analysis functions are held
to the JAX scripts' formulas, written out here, on fixed synthetic
series.  The drivers import neither jax nor the JAX package, and fail
without CUDA unless ``--device cpu`` is given.
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

import jax_driver_references as ref  # noqa: E402
import run_cavity_torch as cavity  # noqa: E402
import run_cylinder_torch as cylinder  # noqa: E402
import run_tgv_torch as tgv  # noqa: E402

torch.set_num_threads(1)
REL = 1e-10          # per-step values of the same f64 computation
FORCE_REL = 1e-8     # forces per step, of the step's largest component

CPU = ["--device", "cpu", "--dtype", "float64"]


# ----------------------------------------------------------------------
# TGV at 8^3, 3 steps
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def tgv_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tgv") / "series.dat"
    port = tgv.run(tgv.parse_args(["--n", "8", "--t-end", "0.06",
                                   "--every", "1", "--out", str(out)]
                                  + CPU))
    jax_solver, jax_rows = ref.run_tgv(ref.tgv_prm(8, 0.02, 0.06))
    return port, jax_solver, jax_rows, out


def test_tgv_driver_matches_jax(tgv_runs):
    port, jax_solver, jax_rows, out = tgv_runs
    assert port["steps"] == len(jax_rows) == 3
    for (t, ke, eps), (tj, kej, _, epsj) in zip(port["series"], jax_rows):
        assert t == pytest.approx(tj, rel=REL)
        assert ke == pytest.approx(kej, rel=REL)
        assert eps == pytest.approx(epsj, rel=REL)
    newton = sum(n for n, _ in jax_solver.solves)
    krylov = sum(k for _, k in jax_solver.solves)
    assert port["newton_solves"] == len(jax_solver.solves)
    assert port["newton_iterations"] == newton
    assert abs(port["fgmres_iterations"] - krylov) <= len(jax_solver.solves)
    assert port["solves_above_tolerance"] == 0
    assert port["gmg_evictions"] == 0
    # the series file: t, KE, eps_resolved, eps_total = -dE/dt
    data = np.loadtxt(out)
    arr = np.asarray(jax_rows)
    np.testing.assert_allclose(data[:, :2], arr[:, :2], rtol=REL)
    np.testing.assert_allclose(
        data[:, 3], -np.gradient(arr[:, 1], arr[:, 0]), rtol=1e-6)


# ----------------------------------------------------------------------
# the Q2 cylinder at refinement 0, 4 steps, Kelly every 2
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def cylinder_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("cyl") / "forces.dat"
    port = cylinder.run(cylinder.parse_args(
        ["--refine", "0", "--t-end", "0.04", "--frequency", "2",
         "--every", "2", "--out", str(out)] + CPU))
    jax_solver, jax_rows = ref.run_cylinder(
        ref.cylinder_prm(2, 0, 0.01, 0.04, frequency=2))
    return port, jax_solver, jax_rows, out


def test_cylinder_driver_matches_jax(cylinder_runs):
    port, jax_solver, jax_rows, out = cylinder_runs
    assert [a["cells"] for a in port["adaptations"]] == jax_solver.cells
    assert len(jax_solver.cells) == 2
    assert len(port["series"]) == len(jax_rows) == 4
    for (t, fx, fy), (tj, fxj, fyj) in zip(port["series"], jax_rows):
        assert t == pytest.approx(tj, rel=REL)
        scale = max(abs(fxj), abs(fyj))
        assert max(abs(fx - fxj), abs(fy - fyj)) <= FORCE_REL * scale
    assert port["newton_iterations"] == sum(n for n, _ in jax_solver.solves)
    np.testing.assert_allclose(np.loadtxt(out), np.asarray(jax_rows),
                               rtol=0, atol=FORCE_REL)


def test_cylinder_driver_resumes_from_its_checkpoint(cylinder_runs,
                                                     tmp_path):
    """Two legs (the checkpoint after step 2, then ``--resume``) give the
    uninterrupted run's series and cells."""
    whole = cylinder_runs[0]
    out = tmp_path / "forces.dat"
    common = ["--refine", "0", "--frequency", "2", "--checkpoint-every",
              "2", "--workdir", str(tmp_path / "run"), "--out", str(out)]
    a = cylinder.run(cylinder.parse_args(["--t-end", "0.02"] + common + CPU))
    b = cylinder.run(cylinder.parse_args(["--t-end", "0.04", "--resume"]
                                         + common + CPU))
    assert a["newton_solves"] + b["newton_solves"] == whole["newton_solves"]
    assert ([c["cells"] for c in a["adaptations"] + b["adaptations"]]
            == [c["cells"] for c in whole["adaptations"]])
    np.testing.assert_allclose(np.asarray(b["series"]),
                               np.asarray(whole["series"]), rtol=0,
                               atol=FORCE_REL)
    np.testing.assert_allclose(np.loadtxt(out), np.asarray(whole["series"]),
                               rtol=0, atol=FORCE_REL)


# ----------------------------------------------------------------------
# the Q2 cavity at 8^2
# ----------------------------------------------------------------------
def test_cavity_driver_matches_jax(tmp_path):
    out = tmp_path / "centerline.dat"
    port = cavity.run(cavity.parse_args(["--n", "8", "--out", str(out)]
                                        + CPU))
    jax_solver, res, (y, ux) = ref.run_cavity(ref.cavity_prm(8, 2))
    assert port["newton_iters"] == int(res.n_iterations)
    assert abs(port["linear_iters"] - int(res.linear_iters)) \
        <= int(res.n_iterations)
    data = np.loadtxt(out)
    np.testing.assert_allclose(data[:, 0], y, rtol=0, atol=1e-14)
    np.testing.assert_allclose(data[:, 1], ux, rtol=0, atol=1e-10)
    np.testing.assert_allclose(port["centerline_u"], ux, rtol=0, atol=1e-10)
    # Ghia's table is the JAX script's
    assert cavity.GHIA_Y == ref.script_constant("run_cavity.py", "GHIA_Y")
    assert cavity.GHIA_U == ref.script_constant("run_cavity.py", "GHIA_U")
    assert cavity.DECK == ref.script_constant("run_cavity.py", "DECK")


# ----------------------------------------------------------------------
# the analysis functions against the JAX scripts' formulas
# ----------------------------------------------------------------------
def test_cylinder_analysis_matches_run_cylinder_formulas():
    """St, Cl' and Cd of a lift sine of known frequency: the formulas of
    scripts/run_cylinder.py:76-94."""
    t = np.arange(1, 701) * 0.01
    f_shed = 3.0                          # St = f D / U = 0.3
    fx = 0.16 + 0.002 * np.sin(2 * math.pi * 2 * f_shed * t)
    fy = 0.05 * np.sin(2 * math.pi * f_shed * t + 0.3)
    arr = np.column_stack([t, fx, fy])
    got = cylinder.analyse(arr)
    # run_cylinder.py, written out
    tail = arr[int(0.6 * len(arr)):]
    cd = 2 * tail[:, 1] / 0.1
    cl = 2 * tail[:, 2] / 0.1
    sign = np.sign(cl - cl.mean())
    crossings = tail[:-1, 0][np.diff(sign) > 0]
    st = 0.1 / np.mean(np.diff(crossings))
    assert got["Cd_mean"] == cd.mean()
    assert got["Cd_max"] == cd.max()
    assert got["Cl_amp"] == (cl.max() - cl.min()) / 2
    assert got["St"] == st
    assert got["St"] == pytest.approx(0.3, abs=2e-3)
    assert got["Cl_amp"] == pytest.approx(1.0, abs=1e-3)
    # fewer than two upward crossings: NaN, as the JAX script
    assert math.isnan(cylinder.analyse(arr[:60])["St"])


def test_tgv_analysis_matches_run_tgv_formulas():
    """Peak -dE/dt and its time of a known KE curve: the formulas of
    scripts/run_tgv.py:83-95."""
    t = np.arange(1, 601) * 0.02
    ke = 0.125 - 0.07 * (1 + np.tanh((t - 8.4) / 2.5)) / 2
    eps = 0.008 * np.exp(-((t - 10.1) / 2.0) ** 2)
    arr = np.column_stack([t, ke, eps])
    got = tgv.analyse(arr)
    dE = -np.gradient(arr[:, 1], arr[:, 0])
    k = int(np.argmax(dE))
    assert got["peak_dissipation"] == float(dE[k])
    assert got["t_peak"] == float(arr[k, 0])
    assert got["peak_resolved"] == float(arr[:, 2].max())
    assert got["t_peak_resolved"] == float(arr[np.argmax(arr[:, 2]), 0])
    assert got["ke_final"] == ke[-1]
    # the curve's own peak: 0.07 / (2 * 2.5) at t = 8.4
    assert got["peak_dissipation"] == pytest.approx(0.014, rel=1e-4)
    assert got["t_peak"] == pytest.approx(8.4, abs=0.011)


def test_cavity_analysis_matches_run_cavity_formulas():
    """u_min and the profile errors of a known centerline: the formulas
    of scripts/run_cavity.py:104-126."""
    y = np.linspace(0.0, 1.0, 513)
    ux = np.sin(math.pi * y) * (y - 0.45) - 0.1 * y ** 3 + y ** 8
    got = cavity.analyse(y, ux)
    ghia_y = ref.script_constant("run_cavity.py", "GHIA_Y")
    ghia_u = ref.script_constant("run_cavity.py", "GHIA_U")
    err = np.abs(np.interp(ghia_y, y, ux) - np.asarray(ghia_u))[1:-1]
    assert got["u_min"] == ux.min()
    assert got["max_profile_err"] == err.max()
    assert got["rms_profile_err"] == np.sqrt((err ** 2).mean())


# ----------------------------------------------------------------------
# no jax, no silent CPU
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["run_tgv_torch", "run_cylinder_torch",
                                  "run_cavity_torch"])
def test_driver_imports_no_jax_and_needs_cuda(name):
    """The driver imports neither jax nor the JAX package, and its
    default ``--device cuda`` fails where CUDA is not available."""
    code = f"""
import importlib, sys
sys.path.insert(0, {SCRIPTS!r})
mod = importlib.import_module({name!r})
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
