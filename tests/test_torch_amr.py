"""Kelly adaptation through the PyTorch package's engines against the JAX
package's, on the CPU in float64 (analogues of ``tests/test_amr.py``,
``tests/test_periodic_amr.py``, ``tests/test_restart_forest.py`` and
``tests/test_gmsh_and_cylinder.py``).

Each deck runs in both packages: the leaves after every adaptation, the
errors or forces, and the solution must agree.  The restart case holds
the port's restarted forest run to its own uninterrupted run.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from softx_2020_200_tpu.core.parameters import \
    SimulationParameters as JaxParameters
from softx_2020_200_tpu.solvers.base import \
    GLSNavierStokesSolver as JaxSolver
from softx_2020_200_tpu_torch.apps.common import run_app
from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
from softx_2020_200_tpu_torch.fem.geometry import det_and_inv
from softx_2020_200_tpu_torch.solvers.base import GLSNavierStokesSolver
from tests.test_gmsh_and_cylinder import _msh41_quad4
from tests.test_golden_apps import numdiff

torch.set_num_threads(1)
KW = dict(device="cpu", dtype=torch.float64)


def _both(text, dim=2):
    """(JAX solver, port solver) on the deck ``text``."""
    return (JaxSolver(JaxParameters.from_text(text, dim=dim)),
            GLSNavierStokesSolver(SimulationParameters.from_text(text,
                                                                 dim=dim),
                                  **KW))


def _leaves(s):
    return [set(x) for x in s.forest.leaves]


def _couette_kelly():
    from tests.test_gls_steady import BASE, COUETTE_BCS
    return BASE.format(nu=0.1, order=1, refine=2, precond="block_jacobi",
                       extra=COUETTE_BCS) + """
subsection mesh adaptation
  set type = kelly
  set variable = velocity
  set fraction refinement = 0.2
  set fraction coarsening = 0
end
"""


def _periodic_kelly():
    from tests.test_periodic_amr import PERIODIC_KELLY_DECK
    return PERIODIC_KELLY_DECK.replace(
        "  set method = steady\n",
        "  set method = steady\n  set number mesh adapt = 1\n")


@pytest.mark.parametrize("case", ["couette", "periodic_q2"])
def test_steady_kelly_cycles_match_jax(case):
    """Steady Kelly cycles: the Couette deck of
    ``test_amr.py::test_steady_amr_cycles_couette`` (Q1, block-Jacobi,
    two cycles) and the periodic Q2 deck of ``test_periodic_amr.py`` (a
    cycle across the periodic seam, forest GMG with the p-level): equal
    leaves, L2 errors per cycle and solution."""
    text = _couette_kelly() if case == "couette" else _periodic_kelly()
    a, b = _both(text)
    if case == "couette":
        for s in (a, b):
            s.prm.simulation_control.number_mesh_adaptation = 2
            s.prm.simulation_control.output_frequency = 0
    ua, ub = a.solve(), b.solve()
    assert _leaves(b) == _leaves(a)
    assert b.hc.n == a.hc.n > 0
    assert len(b.tables["L2"]) == len(a.tables["L2"]) >= 2
    for rb, ra in zip(b.tables["L2"], a.tables["L2"]):
        assert (rb["cells"], rb["dofs"]) == (ra["cells"], ra["dofs"])
        for key in ("error_velocity", "error_pressure"):
            assert rb[key] == pytest.approx(ra[key], rel=1e-6, abs=1e-12)
    np.testing.assert_allclose(ub.numpy(), np.asarray(ua), rtol=0,
                               atol=1e-8)


def test_gmsh_kelly_deck_matches_jax(tmp_path, monkeypatch):
    """A gmsh deck (the 2x2-cell MSH 4.1 square of
    ``test_gmsh_and_cylinder.py``, its boundary ids 10-13, the file named
    relative to the working directory) as a lid-driven cavity with a
    Kelly cycle through the port's CLI prints the JAX CLI's forces."""
    from softx_2020_200_tpu.apps.common import run_app as jax_run_app
    (tmp_path / "square.msh").write_text(_msh41_quad4())
    bcs = "".join(f"""  subsection bc {i}
    set id = {10 + i}
    set type = noslip
  end
""" for i in (0, 1, 3))
    deck = tmp_path / "gmsh_kelly.prm"
    deck.write_text(f"""subsection simulation control
  set method = steady
  set number mesh adapt = 1
  set output frequency = 0
end
subsection physical properties
  set kinematic viscosity = 0.2
end
subsection mesh
  set type = gmsh
  set file name = square.msh
  set initial refinement = 2
end
subsection mesh adaptation
  set type = kelly
  set fraction refinement = 0.3
end
subsection boundary conditions
  set number = 4
{bcs}  subsection bc 2
    set id = 12
    set type = function
    subsection u
      set Function expression = 1
    end
  end
end
subsection forces
  set calculate forces = true
  set verbosity = verbose
end
subsection non-linear solver
  set verbosity = quiet
  set tolerance = 1e-9
end
subsection linear solver
  set relative residual = 1e-6
  set minimum residual = 1e-13
end
subsection test
  set enable = true
end
""")
    monkeypatch.chdir(tmp_path)
    outs = []
    for app, args in ((jax_run_app, [str(deck.name)]),
                      (run_app, [str(deck.name), "--device", "cpu",
                                 "--dtype", "float64"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert app(2, args) == 0
        outs.append(buf.getvalue())
    assert outs[1].count("Force boundary 12") == 2
    numdiff(outs[1], outs[0], rtol=1e-6)


CYLINDER = """
subsection simulation control
  set method = bdf2
  set time step = 0.01
  set time end = 0.02
  set output frequency = 0
end
subsection physical properties
  set kinematic viscosity = 0.001
end
subsection mesh
  set type = dealii
  set grid type = channel_with_cylinder
  set grid arguments = 2.2, 0.41 : 0.2, 0.2 : 0.05
  set initial refinement = 1
end
subsection mesh adaptation
  set type = kelly
  set frequency = 1
  set fraction refinement = 0.12
  set fraction coarsening = 0.02
  set min refinement level = 1
  set max refinement level = 3
end
subsection boundary conditions
  set number = 4
  subsection bc 0
    set id = 0
    set type = function
    subsection u
      set Function expression = 4*1.5*y*(0.41-y)/(0.41*0.41)
    end
  end
  subsection bc 1
    set id = 1
    set type = outlet
  end
  subsection bc 2
    set id = 2
    set type = noslip
  end
  subsection bc 3
    set id = 3
    set type = noslip
  end
end
subsection non-linear solver
  set verbosity = quiet
  set tolerance = 1e-8
end
subsection linear solver
  set relative residual = 1e-6
  set minimum residual = 1e-12
end
subsection test
  set enable = true
end
"""


def test_cylinder_transient_kelly_matches_jax():
    """The cylinder's O-grid (rotated seams) with BDF2 and Kelly after
    every step (the machinery of ``test_amr.py::
    test_cylinder_transient_kelly_amr`` and ``test_gmsh_and_cylinder.py::
    test_cylinder_kelly_adaptation_keeps_cells_valid``): equal leaves
    after each adaptation, positive Jacobians on every adapted mesh and
    the final state."""
    a, b = _both(CYLINDER)
    seen = {"jax": [], "port": []}

    def record(who):
        def on_step(s, u, t):
            seen[who].append(_leaves(s))
            if who == "port":
                xe = torch.as_tensor(s.space.element_coords())
                G = torch.as_tensor(np.array(s.space.basis.quadrature(2)[3]))
                det, _ = det_and_inv(torch.einsum("eni,qnj->eqij", xe, G))
                assert float(det.min()) > 0
        return on_step

    ua = a.run_transient(on_step=record("jax"), verbose=False)
    ub = b.run_transient(on_step=record("port"), verbose=False)
    assert len(seen["port"]) == 2 and seen["port"] == seen["jax"]
    assert b.space.n_elements > 108 and b.hc.n > 0
    np.testing.assert_allclose(ub.numpy(), np.asarray(ua), rtol=0,
                               atol=1e-8 * np.abs(np.asarray(ua)).max())


def test_kelly_restart_matches_uninterrupted(tmp_path):
    """``test_restart_forest.py::test_kelly_restart_matches_uninterrupted``
    in the port: 8 steps with Kelly every 3 and a checkpoint every 4; a
    restart from step 4 (after the adaptation at step 3) ends on the
    uninterrupted run's leaves and state."""
    from tests.test_torch_cli import _forest_solver
    full = _forest_solver("port", tmp_path, 0.4, False, False)
    u_full = full.solve()
    _forest_solver("port", tmp_path, 0.2, True, False).solve()
    again = _forest_solver("port", tmp_path, 0.4, False, True)
    u = again.solve()
    assert _leaves(again) == _leaves(full)
    np.testing.assert_allclose(u.numpy(), u_full.numpy(), rtol=0,
                               atol=1e-10)
