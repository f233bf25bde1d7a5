"""The PyTorch package's grad-div Taylor-Hood solver against the JAX
package's, on the CPU in float64: post-processing on the same seeded
states, then whole solves on the decks of ``tests/test_gd_solver.py``
(Poiseuille exact, the periodic channel, the BDF2 loop with its tables,
and velocity-block GMG against block-Jacobi).

Post-processing agrees to 1e-12 relative; final velocities to 1e-8;
Newton iteration counts are equal and (F)GMRES counts within 1 per
Newton iteration, that is per linear solve (the two packages sum in
different orders, so a Krylov residual that lands next to its target may
take one step more or less).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softx_2020_200_tpu.core.parameters import \
    SimulationParameters as JaxParameters
from softx_2020_200_tpu.fem import mesh as jax_mesh
from softx_2020_200_tpu.solvers import postprocessing as jax_post
from softx_2020_200_tpu.solvers.gd import GDNavierStokesSolver as JaxSolver
from softx_2020_200_tpu.solvers.gd import GDOperator as JaxGDOperator
from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
from softx_2020_200_tpu_torch.fem import mesh as port_mesh
from softx_2020_200_tpu_torch.solvers import postprocessing as port_post
from softx_2020_200_tpu_torch.solvers.gd import (GDNavierStokesSolver,
                                                 GDOperator)
from tests.test_gd_solver import BASE, GD_CAVITY, GD_TRANSIENT_DECK

torch.set_num_threads(1)

CPU = dict(device="cpu", dtype=torch.float64)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


# ----------------------------------------------------------------------
# post-processing
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dim", [2, 3])
def test_gd_postprocessing_matches_jax(dim):
    """Forces and torques on every boundary, kinetic energy and
    enstrophy of one seeded mixed state."""
    meshes = [m.subdivided_hyper_rectangle([0.0] * dim, [1.0, 0.7, 1.3][:dim],
                                           [3, 4, 2][:dim], colorize=True,
                                           dim=dim)
              for m in (jax_mesh, port_mesh)]
    ja = JaxGDOperator(meshes[0], nu=0.05, gamma=0.8, dtype=jnp.float64)
    po = GDOperator(meshes[1], nu=0.05, gamma=0.8, **CPU)
    x = np.random.default_rng(dim).standard_normal(po.n_dofs)
    xa, xp = jnp.asarray(x), torch.as_tensor(x)
    center = np.array([0.3, 0.2, 0.1][:dim])
    faces = po.space_v.boundary_faces
    assert sorted(faces) == list(range(2 * dim))
    for bid in faces:
        fa = ja.space_v.boundary_faces[bid]
        assert _rel(port_post.gd_forces_on_boundary(po, xp, faces[bid]),
                    jax_post.gd_forces_on_boundary(ja, xa, fa)) < 1e-12
        assert _rel(port_post.gd_torques_on_boundary(po, xp, faces[bid],
                                                     center),
                    jax_post.gd_torques_on_boundary(ja, xa, fa,
                                                    center)) < 1e-12
    assert float(port_post.gd_kinetic_energy(po, xp)) == pytest.approx(
        float(jax_post.gd_kinetic_energy(ja, xa)), rel=1e-12)
    assert float(port_post.gd_enstrophy(po, xp)) == pytest.approx(
        float(jax_post.gd_enstrophy(ja, xa)), rel=1e-12)


# ----------------------------------------------------------------------
# whole solves
# ----------------------------------------------------------------------
def _solvers(text):
    """(JAX solver, port solver on the CPU in float64) on one 2D deck."""
    return (JaxSolver(JaxParameters.from_text(text, dim=2)),
            GDNavierStokesSolver(SimulationParameters.from_text(text, dim=2),
                                 **CPU))


def _same_counts(port, ref):
    """Equal Newton iterations and (F)GMRES within 1 per linear solve,
    Newton solve by Newton solve."""
    assert len(port) == len(ref)
    for (n_p, l_p), (n_r, l_r) in zip(port, ref):
        assert n_p == n_r
        assert abs(l_p - l_r) <= max(n_r, 1)


def _counts(res):
    return (int(res.n_iterations), int(res.linear_iters))


def _velocity(solver, x):
    return np.asarray(x)[:solver.op.Nv * solver.dim]


def _steady_pair(text):
    ja, po = _solvers(text)
    xa, ra = ja.solve_steady()
    xp, rp = po.solve_steady()
    _same_counts([_counts(rp)], [_counts(ra)])
    assert _rel(_velocity(po, xp), _velocity(ja, xa)) < 1e-8
    return ja, po, xa, xp, rp


POISEUILLE = """
subsection boundary conditions
  set number = 4
  subsection bc 0
    set id = 0
    set type = function
    subsection u
      set Function expression = 4*y*(1-y)
    end
  end
  subsection bc 1
    set id = 1
    set type = function
    subsection u
      set Function expression = 4*y*(1-y)
    end
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
subsection analytical solution
  set enable = true
  subsection uvwp
    set Function expression = 4*y*(1-y); 0; -8*0.05*x
  end
end
"""


def test_gd_poiseuille_exact():
    """Q2-Q1 holds the parabolic velocity and linear pressure exactly;
    on the lattice path, as in the JAX package."""
    ja, po, xa, xp, rp = _steady_pair(
        BASE.format(nu=0.05, refine=2, extra=POISEUILLE))
    assert po.op.layout_v is not None
    ev, ep = po.l2_errors(xp)
    assert rp.n_iterations <= 8
    assert ev < 1e-8 and ep < 1e-6
    assert ev == pytest.approx(ja.l2_errors(xa)[0], rel=1e-2, abs=1e-12)


def test_gd_periodic_channel():
    """A periodic-in-x channel driven by a body force: Poiseuille
    u = G/(2 nu) y (1-y), exact in Q2."""
    nu, G = 0.1, 1.0
    extra = f"""
subsection boundary conditions
  set number = 4
  subsection bc 0
    set id = 0
    set type = periodic
    set periodic_id = 1
    set periodic_direction = 0
  end
  subsection bc 1
    set id = 1
    set type = periodic
    set periodic_id = 0
    set periodic_direction = 0
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
subsection source term
  set enable = true
  subsection xyz
    set Function expression = {G}; 0; 0
  end
end
subsection analytical solution
  set enable = true
  subsection uvwp
    set Function expression = {G / (2 * nu)}*y*(1-y); 0; 0
  end
end
"""
    _, po, _, xp, _ = _steady_pair(BASE.format(nu=nu, refine=2, extra=extra))
    assert po._mesh.periodic
    assert po.l2_errors(xp)[0] < 1e-8


def _record_steps(solver, records):
    """Wrap ``solve_transient_step`` to record (Newton, GMRES) counts."""
    step = solver.solve_transient_step

    def recorded(*args, **kw):
        x, res = step(*args, **kw)
        records.append(_counts(res))
        return x, res

    solver.solve_transient_step = recorded


def test_gd_transient_loop_and_tables(tmp_path):
    """The BDF2 loop through ``solve()``: the startup sub-step, the same
    Newton and GMRES counts per solve, the same final state, MMS
    accuracy, and the force and kinetic-energy tables on disk."""
    text = GD_TRANSIENT_DECK.format(method="bdf2", dt=0.05, tend=0.2,
                                    outdir=tmp_path, checkpoint="false",
                                    restart="false")
    ja, po = _solvers(text)
    rec_a, rec_p = [], []
    _record_steps(ja, rec_a)
    _record_steps(po, rec_p)
    xa, xp = ja.solve(), po.solve()
    assert len(rec_p) == 5        # 4 steps, the first in two sub-steps
    _same_counts(rec_p, rec_a)
    assert _rel(_velocity(po, xp), _velocity(ja, xa)) < 1e-8
    ev = po.l2_errors(xp, t=0.2)[0]
    assert ev < 2e-4
    assert ev == pytest.approx(ja.l2_errors(xa, t=0.2)[0], rel=1e-6)
    for name in ("force.0.dat", "kinetic_energy.dat"):
        assert os.path.exists(tmp_path / name)
    np.testing.assert_allclose(np.array(po.tables["ke"]),
                               np.array(ja.tables["ke"]), rtol=1e-8)


def test_gd_gmg_beats_block_jacobi():
    """Velocity-block GMG inside the block-triangular Schur
    preconditioner takes at most half block-Jacobi's iterations, with
    the JAX package's counts in both cases, the same velocity, and no
    host reads beyond the solver loop's own."""
    its = {}
    for precond in ("block_jacobi", "gmg"):
        ja, po, xa, xp, rp = _steady_pair(
            GD_CAVITY.format(refine=4, precond=precond))
        assert po.precond_kind == ja.precond_kind == precond
        if precond == "gmg":
            assert len(po.mg_levels) == len(ja._mg_levels) == 2
            assert po.newton_cfg.flexible
        its[precond] = rp.linear_iters
        # the first residual, each FGMRES solve's first residual, one
        # per step, one per restart and one per line-search evaluation
        assert rp.host_syncs == (1 + rp.n_iterations + rp.linear_iters
                                 + rp.linear_restarts + rp.line_search_evals)
        assert po.stats["solves_above_tolerance"] == 0
    assert 2 * its["gmg"] <= its["block_jacobi"]


def test_gd_constructors_default_to_cuda(monkeypatch):
    """The GD solver, operator, kernel wrapper and velocity level run on
    CUDA in float32 unless told otherwise; without CUDA the solver
    raises instead of moving to the CPU."""
    import inspect

    from softx_2020_200_tpu_torch.ops.gd_multigrid import GDVelocityLevel
    from softx_2020_200_tpu_torch.ops.lattice_gd_kernel import \
        LatticeGDKernel
    for cls in (GDNavierStokesSolver, GDOperator, LatticeGDKernel,
                GDVelocityLevel):
        params = inspect.signature(cls.__init__).parameters
        assert params["device"].default == "cuda", cls
        assert params["dtype"].default == torch.float32, cls
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prm = SimulationParameters.from_text(
        GD_CAVITY.format(refine=2, precond="gmg"), dim=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GDNavierStokesSolver(prm)
