"""The check fails what it must fail, at tiny sizes on the CPU: the
control (every state the solver returned, rounded to TF32) and runs
with the timed path broken underneath (a step that returns its state
unchanged; an answer altered where it is produced).  The same control
at the cells' own sizes runs on the card through ``benchmark/control.py``
(marked ``card``)."""

import os
import subprocess
import sys
import time

import pytest
import torch

from benchtools import ROOT, TINY
from benchmark import harness, traffic

SEED = 2 ** 31 + 1234


def _tiny_cell(name):
    spec = TINY[name]
    cell = traffic.load_cell(spec["config"] + (
        ".r5" if "cylinder" in name else ".n96"))
    cell.update(deck=spec["deck"], limits=spec["limits"], episode_steps=2,
                judged_steps=1, warm_steps=3)
    return cell


@pytest.mark.parametrize("name", sorted(TINY))
def test_control_fails_where_the_program_passes(name):
    run = harness.Run(_tiny_cell(name), SEED, "cpu")
    run.setup()
    run.window(0.5)
    run.release()
    limits = TINY[name]["limits"]
    numbers, ok = run.check(limits)
    assert ok, numbers
    control, ok = run.check(limits, control=True)
    assert not ok, control
    # the control fails by a wide margin, on the residual of every step
    assert control["res_window"] > 10 * limits["res_window"]


def _broken(monkeypatch, fault):
    from softx_2020_200_tpu_torch.solvers.base import GLSNavierStokesSolver
    step = GLSNavierStokesSolver.solve_transient_step

    def broken(self, u, previous, t, dts, order, verbose=None):
        new, res = step(self, u, previous, t, dts, order, verbose)
        if fault == "unchanged":
            return u, res
        new = new.clone()
        new[0, 0] += 1e-3
        return new, res

    monkeypatch.setattr(GLSNavierStokesSolver, "solve_transient_step",
                        broken)


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_broken_step_is_not_correct(tiny_root, monkeypatch, fault):
    _broken(monkeypatch, fault)
    out = harness.execute("tgv_re1600_q1.n8", SEED, 0.5, False,
                          time.perf_counter(), tiny_root, device="cpu")
    assert out["correct"] is False
    assert out["checks"]["res_setup"]["value"] > \
        out["checks"]["res_setup"]["limit"]


@pytest.mark.card
def test_control_on_the_card():
    """The program's and the control's numbers at the r5 cell's own
    size, on three seeds (on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run on the GPU")
    proc = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload",
         "cylinder_re100_q2.r5", "--seeds", "1,2,3", "--seconds", "3"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert '"control_fails": true' in proc.stdout
    assert '"program_passes": true' in proc.stdout
    assert os.path.exists(os.path.join(ROOT, "benchmark", "control.py"))
