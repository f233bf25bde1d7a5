"""The PyTorch solver against the JAX solver, whole solves on the CPU in
float64.

- steady Taylor-Couette (Q2 on a curved shell, refinement 1, block-Jacobi
  in both packages);
- the golden transient deck ``tests/golden/mms_bdf2.prm`` (BDF2 with
  startup sub-steps, MMS source, function boundary values), with
  block-Jacobi in both (multigrid solves are held by
  ``tests/test_torch_multigrid.py``);
- a periodic 3D Taylor-Green vortex on 4^3 Q1 cells, 2 steps (the port
  on its lattice path, the JAX package on its XLA path);
- skip-Newton on a small cavity;
- the constructors' default device.

Final states agree to 1e-8 relative, Newton iteration counts are equal
and GMRES counts within 1 per solve (the two packages sum in different
orders, so a Krylov residual that lands next to its target may take one
step more or less).
"""

import os

import numpy as np
import pytest
import torch

from softx_2020_200_tpu.core.parameters import \
    SimulationParameters as JaxParameters
from softx_2020_200_tpu.solvers import postprocessing as jax_post
from softx_2020_200_tpu.solvers.base import \
    GLSNavierStokesSolver as JaxSolver
from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
from softx_2020_200_tpu_torch.solvers import postprocessing as port_post
from softx_2020_200_tpu_torch.solvers.base import GLSNavierStokesSolver

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _deck(path, **edits):
    with open(os.path.join(ROOT, path)) as fh:
        text = fh.read()
    for key, value in edits.items():
        key = key.replace("_", " ")
        lines = [ln for ln in text.splitlines()
                 if ln.strip().startswith(f"set {key} ")]
        assert len(lines) == 1, key
        text = text.replace(lines[0], f"  set {key} = {value}")
    return text


def _block_jacobi(text):
    return text.replace("subsection linear solver\n",
                        "subsection linear solver\n"
                        "  set preconditioner = block_jacobi\n", 1)


def _solvers(text, dim, tmp_path):
    """(JAX solver, port solver) on the same deck, output in tmp_path."""
    text = _deck_output(text, tmp_path)
    return (JaxSolver(JaxParameters.from_text(text, dim=dim)),
            GLSNavierStokesSolver(SimulationParameters.from_text(text,
                                                                 dim=dim),
                                  device="cpu", dtype=torch.float64))


def _deck_output(text, tmp_path):
    return text.replace("subsection simulation control\n",
                        "subsection simulation control\n"
                        f"  set output path = {tmp_path}/\n", 1)


def _record_steps(solver, records):
    """Wrap ``solve_transient_step`` to record (Newton, GMRES) counts."""
    step = solver.solve_transient_step

    def recorded(*args, **kw):
        u, res = step(*args, **kw)
        records.append((int(res.n_iterations), int(res.linear_iters)))
        return u, res

    solver.solve_transient_step = recorded


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _rel_state(a, b):
    """Relative difference of two states [N, d+1]; where Dirichlet data
    on the whole boundary leave the pressure defined up to a constant,
    the nodal pressure mean is removed from both first (GMRES reaches
    the nullspace component along a path that depends on rounding)."""
    a, b = np.array(a), np.array(b)
    a[:, -1] -= a[:, -1].mean()
    b[:, -1] -= b[:, -1].mean()
    return _rel(a, b)


def _same_counts(port, ref):
    assert len(port) == len(ref)
    for (n_p, l_p), (n_r, l_r) in zip(port, ref):
        assert n_p == n_r
        assert abs(l_p - l_r) <= 1


def test_taylor_couette_steady_matches_jax(tmp_path):
    text = _block_jacobi(_deck("examples/taylor_couette_mms.prm",
                               number_mesh_adapt=0))
    ja, po = _solvers(text, 2, tmp_path)
    assert po.precond_kind == ja.precond_kind == "block_jacobi"
    ua, ra = ja.solve_steady(verbose=False)
    up, rp = po.solve_steady(verbose=False)
    assert _rel(up, ua) < 1e-8
    _same_counts([(rp.n_iterations, rp.linear_iters)],
                 [(int(ra.n_iterations), int(ra.linear_iters))])
    ev_a, ep_a = ja.l2_errors(ua)
    ev_p, ep_p = po.l2_errors(up)
    assert ev_p == pytest.approx(ev_a, rel=1e-6)
    assert ep_p == pytest.approx(ep_a, rel=1e-6)
    # torques on both cylinders (the deck's post-processing)
    for bid, faces in sorted(po.space.boundary_faces.items()):
        ta = np.asarray(jax_post.torques_on_boundary(
            ja.op, ua, ja.space.boundary_faces[bid], center=np.zeros(2)))
        tp = port_post.torques_on_boundary(po.op, up, faces,
                                           center=np.zeros(2)).numpy()
        np.testing.assert_allclose(tp, ta, rtol=1e-7, atol=1e-12)
    # one host read per Krylov step, per line-search evaluation and per
    # restart: the count is bounded by the work done
    assert rp.host_syncs >= 1 + rp.linear_iters + rp.n_iterations


def test_mms_bdf2_matches_jax(tmp_path):
    text = _block_jacobi(_deck("tests/golden/mms_bdf2.prm"))
    ja, po = _solvers(text, 2, tmp_path)
    rec_a, rec_p = [], []
    _record_steps(ja, rec_a)
    _record_steps(po, rec_p)
    ua = ja.run_transient(verbose=False)
    up = po.run_transient(verbose=False)
    assert _rel_state(up, ua) < 1e-8
    # 3 steps, the first split into two startup sub-steps
    assert len(rec_p) == 4
    _same_counts(rec_p, rec_a)
    assert po.l2_errors(up, 0.3)[0] == pytest.approx(
        ja.l2_errors(ua, 0.3)[0], rel=1e-6)


TGV = """
subsection simulation control
  set method = bdf2
  set time step = 0.05
  set time end = 0.1
  set output frequency = 0
end
subsection physical properties
  set kinematic viscosity = 0.01
end
subsection mesh
  set type = dealii
  set grid type = subdivided_hyper_rectangle
  set grid arguments = 4, 4, 4 : 0, 0, 0 : 6.283185307179586, 6.283185307179586, 6.283185307179586 : true
end
subsection boundary conditions
  set number = 3
  subsection bc 0
    set id = 0
    set type = periodic
    set periodic_id = 1
    set periodic_direction = 0
  end
  subsection bc 1
    set id = 2
    set type = periodic
    set periodic_id = 3
    set periodic_direction = 1
  end
  subsection bc 2
    set id = 4
    set type = periodic
    set periodic_id = 5
    set periodic_direction = 2
  end
end
subsection initial conditions
  set type = nodal
  subsection uvwp
    set Function expression = sin(x)*cos(y)*cos(z); -cos(x)*sin(y)*cos(z); 0; 0.0625*(cos(2*x)+cos(2*y))*(cos(2*z)+2)
  end
end
subsection post-processing
  set calculate kinetic energy = true
  set calculate enstrophy = true
end
subsection non-linear solver
  set verbosity = quiet
  set tolerance = 1e-8
  set max iterations = 8
end
subsection linear solver
  set verbosity = quiet
  set relative residual = 1e-4
  set minimum residual = 1e-10
  set preconditioner = block_jacobi
end
"""


def test_tgv3d_periodic_matches_jax(tmp_path):
    ja, po = _solvers(TGV, 3, tmp_path)
    assert not bool(po.bh.mask.any())
    rec_a, rec_p = [], []
    _record_steps(ja, rec_a)
    _record_steps(po, rec_p)
    ua = ja.run_transient(verbose=False)
    up = po.run_transient(verbose=False)
    assert _rel(up, ua) < 1e-8
    _same_counts(rec_p, rec_a)
    for key in ("ke", "enstrophy"):
        got, want = np.array(po.tables[key]), np.array(ja.tables[key])
        assert got.shape == want.shape == (2, 2)
        np.testing.assert_allclose(got, want, rtol=1e-10)
    assert np.all(np.diff(np.array(po.tables["ke"])[:, 1]) < 0)


def test_skip_newton_matches_jax(tmp_path):
    text = """
subsection simulation control
  set method = steady
end
subsection physical properties
  set kinematic viscosity = 0.05
end
subsection mesh
  set type = dealii
  set grid type = hyper_cube
  set grid arguments = 0 : 1 : true
  set initial refinement = 2
end
subsection boundary conditions
  set number = 4
  subsection bc 0
    set id = 0
    set type = noslip
  end
  subsection bc 1
    set id = 1
    set type = noslip
  end
  subsection bc 2
    set id = 2
    set type = noslip
  end
  subsection bc 3
    set id = 3
    set type = function
    subsection u
      set Function expression = 1
    end
  end
end
subsection non-linear solver
  set verbosity = quiet
  set solver = skip_newton
  set skip iterations = 3
  set tolerance = 1e-9
  set max iterations = 15
end
subsection linear solver
  set verbosity = quiet
  set relative residual = 1e-4
  set preconditioner = block_jacobi
end
"""
    ja, po = _solvers(text, 2, tmp_path)
    ua, ra = ja.solve_steady(verbose=False)
    up, rp = po.solve_steady(verbose=False)
    assert _rel(up, ua) < 1e-8
    _same_counts([(rp.n_iterations, rp.linear_iters)],
                 [(int(ra.n_iterations), int(ra.linear_iters))])


def test_constructors_default_to_cuda(tmp_path, monkeypatch):
    """The solver, operator, boundary handler and both kernel wrappers run
    on CUDA in float32 unless told otherwise; without CUDA the solver
    raises instead of moving to the CPU."""
    import inspect

    from softx_2020_200_tpu_torch.ops.gls_kernel import GLSElementKernel
    from softx_2020_200_tpu_torch.ops.lattice_kernel import LatticeGLSKernel
    from softx_2020_200_tpu_torch.solvers.boundary import BoundaryHandler
    from softx_2020_200_tpu_torch.solvers.gls import GLSOperator
    for cls in (GLSNavierStokesSolver, GLSOperator, BoundaryHandler,
                GLSElementKernel, LatticeGLSKernel):
        params = inspect.signature(cls.__init__).parameters
        assert params["device"].default == "cuda", cls
        assert params["dtype"].default == torch.float32, cls
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prm = SimulationParameters.from_text(_deck_output(TGV, tmp_path), dim=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GLSNavierStokesSolver(prm)
