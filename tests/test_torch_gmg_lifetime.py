"""The lifetime of the multigrid preconditioner's state, on the CPU in
float64 with Python's cyclic collector off.

A cycle built at one Newton iterate holds every level's linearization
and block-Jacobi inverses.  Nothing in it refers back to it, so
reference counting frees all of it when the last reference to its
``apply`` goes, and ``newton_solve`` drops an iteration's preconditioner
and Jacobian before it builds the next ones:

- every level's ``Linearization`` and block-Jacobi state die with the
  last ``apply`` (lattice and forest hierarchies, both smoothers, v, w
  and k cycles, the sharded path's coarse cycle with ``level_offset``
  1, and the GD velocity cycle), and the live-state tally
  (``core/spans.py``) falls back;
- ``newton_solve`` builds each preconditioner and Jacobian with none of
  the previous iteration's alive;
- one transient step of a periodic lattice TGV and of a Q2 cylinder on
  the forest leaves no tensor in a reference cycle, and under the
  profiler each build finds one live state, its own;
- the cycles' outputs and the steps' states and Newton and FGMRES counts
  are bit for bit those recorded from the closure-built cycles that
  these classes replaced.
"""

import gc
import hashlib
import weakref

import numpy as np
import pytest
import torch
# torch imports its compiler stack lazily at the first functorch
# transform (the plain node blocks' vmap); a call that imports leaves
# its frames, and the state they hold, in a reference cycle (torch.fx's
# ``wrap`` keeps its own frame), once per process: import it first
import torch._dynamo  # noqa: F401
from torch.profiler import ProfilerActivity, profile

from softx_2020_200_tpu_torch.core import spans
from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
from softx_2020_200_tpu_torch.ops import gd_multigrid, multigrid
from softx_2020_200_tpu_torch.solvers.base import (GLSNavierStokesSolver,
                                                   new_stats)
from softx_2020_200_tpu_torch.solvers.gd import GDNavierStokesSolver
from softx_2020_200_tpu_torch.solvers.newton import (NewtonConfig,
                                                     newton_solve)
from tests.test_torch_gd_multigrid import cavity as gd_cavity
from tests.test_torch_multigrid import _cavity

torch.set_num_threads(1)

KW = dict(device="cpu", dtype=torch.float64)
L = "6.283185307179586"

# the 2D Taylor-Green vortex on a periodic 32^2 Q1 lattice: lattice GMG
# on 32^2 and 16^2 with the Jacobi smoother
TGV = f"""
subsection simulation control
  set method = bdf2
  set time step = 0.05
  set output frequency = 0
end
subsection physical properties
  set kinematic viscosity = 0.01
end
subsection mesh
  set type = dealii
  set grid type = subdivided_hyper_rectangle
  set grid arguments = 32, 32 : 0, 0 : {L}, {L} : true
end
subsection boundary conditions
  set number = 2
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
end
subsection initial conditions
  set type = nodal
  subsection uvwp
    set Function expression = sin(x)*cos(y); -cos(x)*sin(y); 0
  end
end
subsection non-linear solver
  set verbosity = quiet
  set tolerance = 1e-8
end
subsection linear solver
  set verbosity = quiet
  set relative residual = 1e-3
  set minimum residual = 1e-10
end
"""

# Schaefer-Turek 2D-2 in Q2 at refinement 1 (108 cells) on the forest:
# forest GMG on Q2, its Q1 p-level and one coarser forest level, with
# the Krylov smoother
CYLINDER = """
subsection simulation control
  set method = bdf2
  set time step = 0.01
  set output frequency = 0
end
subsection physical properties
  set kinematic viscosity = 0.001
end
subsection FEM
  set velocity order = 2
  set pressure order = 2
end
subsection mesh
  set type = dealii
  set grid type = channel_with_cylinder
  set grid arguments = 2.2, 0.41 : 0.2, 0.2 : 0.05
  set initial refinement = 1
end
subsection mesh adaptation
  set type = kelly
  set frequency = 50
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
  set verbosity = quiet
  set relative residual = 1e-3
  set minimum residual = 1e-10
end
"""


def _solver(text, dim=2):
    return GLSNavierStokesSolver(SimulationParameters.from_text(text, dim),
                                 **KW)


def _digest(x) -> str:
    return hashlib.sha256(
        x.detach().contiguous().numpy().tobytes()).hexdigest()[:16]


@pytest.fixture(scope="module")
def hierarchies(tmp_path_factory):
    """The lattice levels of a Q1 cavity (8^2, 4^2, 2^2), the forest
    levels of the cylinder (Q2, Q1, one coarser forest level) and the
    GD cavity's velocity levels (32^2, 16^2, 8^2)."""
    lattice = _solver(_cavity(tmp_path_factory.mktemp("cavity")))
    forest = _solver(CYLINDER)
    gd = GDNavierStokesSolver(
        SimulationParameters.from_text(gd_cavity(refine=5), 2), **KW)
    assert len(forest.mg_levels) == 3 and forest.forest is not None
    assert len(gd.mg_levels) == 3
    return {"lattice": multigrid.build_hierarchy(lattice, min_elems=4),
            "forest": forest.mg_levels, "gd": gd.mg_levels}


# case -> (hierarchy, make_vcycle's options); "offset" is the sharded
# path's coarse cycle: the levels below the finest, level_offset 1
CASES = {
    "lattice-jacobi-v": ("lattice", dict(smoother="jacobi", cycle="v")),
    "lattice-jacobi-w": ("lattice", dict(smoother="jacobi", cycle="w")),
    "lattice-jacobi-k": ("lattice", dict(smoother="jacobi", cycle="k")),
    "lattice-krylov-v": ("lattice", dict(smoother="krylov", cycle="v")),
    "lattice-krylov-w": ("lattice", dict(smoother="krylov", cycle="w")),
    "lattice-krylov-k": ("lattice", dict(smoother="krylov", cycle="k")),
    "offset-krylov-k": ("lattice", dict(smoother="krylov", cycle="k",
                                        level_offset=1)),
    "forest-jacobi-v": ("forest", dict(smoother="jacobi", cycle="v")),
    "forest-krylov-v": ("forest", dict(smoother="krylov", cycle="v")),
    "forest-krylov-k": ("forest", dict(smoother="krylov", cycle="k")),
    "gd": ("gd", {}),
}


def _build(hierarchies, case):
    """(builder, its arguments, a right-hand side) for ``case``, the
    inputs drawn from a fixed seed."""
    kind, kw = CASES[case]
    levels = hierarchies[kind]
    rng = np.random.default_rng(11)
    t = torch.as_tensor
    if kind == "gd":
        N = levels[0].mask.shape[0]
        r = rng.standard_normal((N, 2))
        r[levels[0].mask.numpy()] = 0.0
        return (gd_multigrid.make_gd_vcycle(levels),
                (t(rng.standard_normal((N, 2)) * 0.5), 20.0), t(r))
    if kw.get("level_offset"):
        levels = levels[1:]
    op = levels[0].op
    N, E = op.space.n_nodes, op.space.n_elements
    args = (t(rng.standard_normal((N, 3)) * 0.3),
            t(rng.standard_normal((N, 2)) * 0.2),
            t(rng.standard_normal((E, op.n_q, 2))), 10.0, 10.0,
            levels[0].mask)
    builder = multigrid.make_vcycle(levels, coarse_iters=6, krylov_m=3,
                                    **kw)
    return builder, args, t(rng.standard_normal((N, 3)))


def _level_refs(cycle):
    """Weak references to each level's linearization (the GD levels':
    the velocity at the quadrature points) and block-Jacobi inverses."""
    return [ref for state in cycle.states
            for ref in (weakref.ref(state[0]), weakref.ref(state[-1]))]


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_dies_with_its_last_apply(hierarchies, case):
    builder, args, r = _build(hierarchies, case)
    gc.collect()
    gc.disable()
    try:
        live = spans.live_states()
        apply = builder(*args)
        assert spans.live_states() == live + 1
        z = apply(r)
        refs = _level_refs(apply.__self__)
        assert len(refs) == 2 * len(apply.__self__.states) >= 4
        assert all(ref() is not None for ref in refs)
        del apply
        assert [ref() is None for ref in refs] == [True] * len(refs)
        assert spans.live_states() == live
    finally:
        gc.enable()
    assert bool(torch.isfinite(z).all())


# the cycles' outputs, recorded from the closure-built cycles: sha256 of
# the float64 bytes
CYCLE_DIGESTS = {
    "forest-jacobi-v": "ff908a2233a62707",
    "forest-krylov-k": "cc518ee240ea3c10",
    "forest-krylov-v": "710daf9644a0b85f",
    "gd": "cbb5976fc06596af",
    "lattice-jacobi-k": "b2f12da6d56be888",
    "lattice-jacobi-v": "42da5f518f342bf5",
    "lattice-jacobi-w": "c756205276c38bb8",
    "lattice-krylov-k": "061ec84422e55df7",
    "lattice-krylov-v": "f6a7191abd6ae794",
    "lattice-krylov-w": "2b7e9b7c46c7e23c",
    "offset-krylov-k": "766742233b7e7aac",
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cycle_output_is_unchanged(hierarchies, case):
    builder, args, r = _build(hierarchies, case)
    assert _digest(builder(*args)(r)) == CYCLE_DIGESTS[case]


def test_newton_drops_the_old_preconditioner_first():
    """A cubic system that takes several Newton iterations: when each
    Jacobian and preconditioner is built, none built before is
    alive."""
    n = 12
    gen = torch.Generator().manual_seed(5)
    A = torch.eye(n, dtype=torch.float64) * 3 + 0.2 * torch.randn(
        n, n, generator=gen, dtype=torch.float64)
    b = torch.randn(n, 1, generator=gen, dtype=torch.float64)

    class Held:
        """What a build keeps: the iterate it was built at."""

        def __init__(self, u):
            self.u = u

    built = {"jacobian": [], "precond": []}
    alive_at_build = []

    def alive():
        return sum(ref() is not None for refs in built.values()
                   for ref in refs)

    def residual(u):
        return A @ u + u ** 3 - b

    def jacobian(u):
        alive_at_build.append(alive())
        held = Held(u)
        built["jacobian"].append(weakref.ref(held))
        return lambda v: A @ v + 3 * held.u ** 2 * v

    def precond_builder(u):
        alive_at_build.append(alive())
        held = Held(torch.diagonal(A)[:, None] + 3 * u ** 2)
        built["precond"].append(weakref.ref(held))
        return lambda v: v / held.u

    gc.collect()
    gc.disable()
    try:
        res = newton_solve(residual, jacobian, torch.zeros(n, 1,
                                                           dtype=A.dtype),
                           precond_builder=precond_builder,
                           config=NewtonConfig(tolerance=1e-9,
                                               relative_residual=1e-2))
    finally:
        gc.enable()
    assert res.n_iterations >= 3
    assert res.res_history[res.n_iterations] < 1e-9
    assert len(alive_at_build) == 2 * res.n_iterations
    # the Jacobian is built first, with nothing alive; the
    # preconditioner after it, with the new Jacobian alone
    assert alive_at_build == [0, 1] * res.n_iterations


# deck -> (the step's Newton iterations, FGMRES iterations, the new
# state's digest), recorded from the closure-built cycles
STEPS = {"cylinder": (4, 15, "43a6f9f2309b4388"),
         "tgv": (3, 12, "0730c327bc74dae2")}


@pytest.fixture(scope="module", params=sorted(STEPS))
def step(request):
    """One transient step from the initial field, with the collector
    off and every object it finds unreachable kept in ``gc.garbage``;
    under the profiler, so that the build counters move."""
    s = _solver({"tgv": TGV, "cylinder": CYLINDER}[request.param])
    assert s.precond_kind == "gmg" and len(s.mg_levels) >= 2
    u0 = s.initial_condition()
    dt = s.control.dt
    spans.fold(new_stats())
    stats0 = dict(s.stats)
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            u, res = s.solve_transient_step(u0, [u0, u0, u0], dt,
                                            np.full(3, dt), 2,
                                            verbose=False)
        gc.collect()
        garbage = [type(o).__name__ for o in gc.garbage
                   if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    return dict(deck=request.param, u=u, res=res, garbage=garbage,
                stats={k: s.stats[k] - stats0[k] for k in s.stats})


def test_a_step_leaves_no_tensor_in_a_cycle(step):
    assert step["garbage"] == []


def test_each_build_finds_one_live_state(step):
    stats = step["stats"]
    assert stats["gmg_builds"] == step["res"].n_iterations > 0
    assert stats["gmg_states_live"] == stats["gmg_builds"]


def test_step_is_unchanged(step):
    res = step["res"]
    assert (res.n_iterations, res.linear_iters,
            _digest(step["u"])) == STEPS[step["deck"]]
