"""The program's spans and counters (``core/spans.py``) on the CPU.

A periodic Q1 lattice BDF2 step (8^3, 2 multigrid levels) and a forest
step (a Q1 cavity refined towards its lid's corners, so that it has
hanging nodes, forest multigrid):

- with no profiler, nothing is recorded and the span counters stay 0;
- under ``torch.profiler``, the fixed span names are among the
  profiler's events, nested step > Newton iteration > Arnoldi step >
  V-cycle > level-0 smoothing, and the counters move;
- the state and the Newton, FGMRES and host-read counts are bitwise the
  same with spans on and off;
- each gather site's counted bytes are its rows and index, from their
  shapes;
- ``solver.stats`` stays flat and numeric, so a window's difference of
  it runs.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.autograd.profiler
from torch.profiler import ProfilerActivity, profile

from softx_2020_200_tpu_torch.core import spans
from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
from softx_2020_200_tpu_torch.core.timer import SectionTimer
from softx_2020_200_tpu_torch.ops.multigrid import (build_hierarchy,
                                                    make_vcycle, prolong,
                                                    restrict)
from softx_2020_200_tpu_torch.ops.preconditioners import \
    build_additive_schwarz
from softx_2020_200_tpu_torch.solvers.base import (GLSNavierStokesSolver,
                                                   new_stats)

torch.set_num_threads(1)

L = "6.283185307179586"

TGV = f"""
subsection simulation control
  set method = bdf2
  set time step = 0.05
  set output frequency = 0
end
subsection physical properties
  set kinematic viscosity = 0.000625
end
subsection mesh
  set type = dealii
  set grid type = subdivided_hyper_rectangle
  set grid arguments = 8, 8, 8 : 0, 0, 0 : {L}, {L}, {L} : true
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
    set Function expression = sin(x)*cos(y)*cos(z); -cos(x)*sin(y)*cos(z); 0; 0
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
  set preconditioner = gmg
end
"""

CAVITY = """
subsection simulation control
  set method = bdf2
  set time step = 0.05
  set output frequency = 0
end
subsection physical properties
  set kinematic viscosity = 0.05
end
subsection mesh
  set type = dealii
  set grid type = hyper_cube
  set grid arguments = 0 : 1 : true
  set initial refinement = 4
end
subsection mesh adaptation
  set type = kelly
  set fraction type = number
  set fraction refinement = 0.2
  set max refinement level = 8
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
  set tolerance = 1e-8
end
subsection linear solver
  set verbosity = quiet
  set relative residual = 1e-3
  set minimum residual = 1e-10
  set preconditioner = gmg
end
"""

KW = dict(device="cpu", dtype=torch.float64)
NEST = ("step", "newton.iteration", "krylov.arnoldi", "gmg.cycle",
        "gmg.L0.smooth")
NAMES = set(NEST) | {"newton.linearize", "newton.precond_build",
                     "newton.line_search", "krylov.solve",
                     "krylov.orthogonalize", "krylov.matvec", "krylov.fixed",
                     "sync", "gmg.build", "gmg.L0.residual",
                     "gmg.L0.restrict", "gmg.L0.prolong", "op.residual",
                     "op.jvp", "op.node_blocks", "gather.transfer",
                     "gather.operator"}
OLD_KEYS = ("newton_solves", "newton_iterations", "linear_iterations",
            "host_syncs", "line_search_evaluations", "linear_restarts",
            "solves_above_tolerance")


def _lattice():
    """The 8^3 TGV with two lattice levels (8^3 and 4^3)."""
    s = GLSNavierStokesSolver(SimulationParameters.from_text(TGV, 3), **KW)
    s.mg_levels = build_hierarchy(s, min_elems=64)
    assert len(s.mg_levels) == 2
    s._vcycle = make_vcycle(s.mg_levels)
    s.precond_kind = "gmg"
    s.newton_cfg = dataclasses.replace(s.newton_cfg, flexible=True)
    return s


def _forest():
    """The 16^2 cavity with the cells at its lid's corners refined twice,
    on the forest: hanging nodes on the finest levels."""
    s = GLSNavierStokesSolver(SimulationParameters.from_text(CAVITY, 2), **KW)
    f = s.forest
    for _ in range(2):
        b, lvl, idx = f._leaf_arrays_only()
        n = 1 << lvl
        top = idx[:, 1] == n - 1
        side = (idx[:, 0] == 0) | (idx[:, 0] == n - 1)
        f.refine(np.column_stack([b, lvl, idx])[top & side])
        f.balance()
    mesh, s._elem_of, ncf = f.build_mesh()
    s.setup(mesh=mesh, nc_faces=ncf)
    assert s.hc.n > 0 and s.precond_kind == "gmg" and len(s.mg_levels) > 2
    return s


BUILD = {"lattice": _lattice, "forest": _forest}


def _step(s):
    u0 = s.initial_condition()
    dt = s.control.dt
    stats0 = dict(s.stats)
    u, res = s.solve_transient_step(u0, [u0, u0, u0], dt, np.full(3, dt), 2,
                                    verbose=False)
    return u, res, {k: s.stats[k] - stats0[k] for k in s.stats}


def _profiled(fn):
    """``fn()`` under a CPU profiler: (its result, the profiler's events
    as (name, start, end) on the calling thread)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        out = fn()
    assert not torch.autograd.profiler._is_profiler_enabled
    events = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events()]
    return out, events


@pytest.fixture(scope="module", params=sorted(BUILD))
def runs(request):
    """One step of a fresh solver without a profiler and one of another
    under it, from the same state."""
    spans.fold(new_stats())
    off = _step(BUILD[request.param]())
    left = dict(spans._counts)
    on, events = _profiled(lambda: _step(BUILD[request.param]()))
    return dict(mesh=request.param, off=off, on=on, events=events,
                left=left)


def test_without_a_profiler_nothing_is_recorded(runs):
    assert spans.span("step") is spans.span("gmg.cycle", "vcycle_s")
    assert all(v == 0 for v in runs["left"].values())
    delta = runs["off"][2]
    assert all(delta[k] == 0 for k in spans.COUNTERS), delta


def test_spans_nest_on_the_profilers_thread(runs):
    events = runs["events"]
    assert NAMES <= {name for name, _, _ in events}
    if runs["mesh"] == "forest":
        assert {"gmg.L1.smooth", "gmg.L1.restrict"} <= {
            name for name, _, _ in events}
    # an innermost level-0 smoothing inside a V-cycle inside an Arnoldi
    # step inside a Newton iteration inside the step
    inner = [e for e in events if e[0] == NEST[-1]]
    assert inner
    for name in reversed(NEST[:-1]):
        outer = [e for e in events if e[0] == name
                 and any(e[1] <= i[1] and i[2] <= e[2] for i in inner)]
        assert outer, name
        inner = outer
    assert len(inner) == 1          # one step


def test_spans_change_no_result(runs):
    u_off, res_off, d_off = runs["off"]
    u_on, res_on, d_on = runs["on"]
    assert torch.equal(u_off, u_on)
    for a, b in zip(res_off, res_on):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        elif not isinstance(a, torch.Tensor):
            assert a == b
    assert {k: d_off[k] for k in OLD_KEYS} == {k: d_on[k] for k in OLD_KEYS}
    # every FGMRES step applies one V-cycle; every host read is a span
    assert d_on["vcycles"] == d_on["linear_iterations"] > 0
    assert d_on["vcycle_s"] > 0 and d_on["sync_wait_s"] > 0
    assert d_on["sync_wait_s"] < d_on["newton_seconds"]
    assert d_on["gather_calls_transfer"] > 0
    assert d_on["gather_calls_operator"] > 0
    assert (d_on["gather_calls_constraints"] > 0) == (
        runs["mesh"] == "forest")
    assert d_on["gather_calls_smoother"] == 0      # block-Jacobi smoother
    assert all(spans._counts[k] == v for k, v in spans.COUNTERS.items())


def test_stats_are_flat_numbers(runs):
    stats = new_stats()
    assert set(spans.COUNTERS) <= set(stats)
    assert all(type(v) in (int, float) for v in stats.values())
    delta = runs["on"][2]
    assert set(delta) == set(stats)
    assert all(type(v) in (int, float) for v in delta.values())


def _counted(fn):
    """The span counters that ``fn()`` moves under a profiler."""
    spans.fold(new_stats())
    _profiled(fn)
    out = new_stats()
    spans.fold(out)
    return {k: out[k] for k in spans.COUNTERS if out[k]}


def _nb(*tensors_or_shapes):
    """Bytes of float64 rows and int64 indices given by shape."""
    return sum(8 * int(np.prod(s)) for s in tensors_or_shapes)


def test_gather_bytes_are_the_sites_shapes():
    """Each site's bytes: its gathered rows (or indexed values) and its
    index, float64 and int64, from their shapes."""
    s = _forest()
    op, hc = s.op, s.hc
    N, c, E, nn = op.n_nodes, op.nc, op.space.n_elements, op.nn
    g = torch.Generator().manual_seed(0)
    u = torch.rand((N, c), generator=g, dtype=torch.float64)
    # the operator: element rows in, the gather-sum out
    M = op.amap_idx.shape[1]
    assert _counted(lambda: op._soa(u)) == {
        "gather_bytes_operator": _nb((nn, E, c), (nn, E)),
        "gather_calls_operator": 1}
    rows = torch.rand((nn, c, E), generator=g, dtype=torch.float64)
    assert _counted(lambda: op._assemble_rows(rows)) == {
        "gather_bytes_operator": _nb((N, M, c), (N, M)),
        "gather_calls_operator": 1}
    # the hanging-node constraints: the masters' rows, then the written
    # values; the transpose's three reads and two writes
    H, Mh = hc.masters.shape
    U, K = hc.slots.shape
    assert _counted(lambda: hc.distribute(u)) == {
        "gather_bytes_constraints": _nb((H, Mh, c), (H, Mh), (H, c), (H,)),
        "gather_calls_constraints": 2}
    assert _counted(lambda: hc.distribute_transpose(u)) == {
        "gather_bytes_constraints": _nb(
            (H, c), (H,), (U, c), (U,), (U, K, c), (U, K), (U, c), (U,),
            (H, c), (H,)),
        "gather_calls_constraints": 5}
    # the forest transfers: interpolation down, prolongation, restriction
    lvl = s.mg_levels[1]
    N1 = lvl.mask.shape[0]
    Mi, Mp, Mr = (lvl.inj_masters.shape[1], lvl.masters.shape[1],
                  lvl.restrict_idx.shape[1])
    assert _counted(lambda: lvl.down(u)) == {
        "gather_bytes_transfer": _nb((N1, Mi, c), (N1, Mi)),
        "gather_calls_transfer": 1}
    uc = torch.zeros((N1, c), dtype=torch.float64)
    if lvl.hc is not None and lvl.hc.n:
        uc_hc = _counted(lambda: lvl.hc_distribute(uc))
    else:
        uc_hc = {}
    assert _counted(lambda: prolong(lvl, uc)) == {
        "gather_bytes_transfer": _nb((N, Mp, c), (N, Mp)),
        "gather_calls_transfer": 1, **uc_hc}
    got = _counted(lambda: restrict(lvl, u))
    assert {k: v for k, v in got.items() if "transfer" in k} == {
        "gather_bytes_transfer": _nb((N1, Mr, c), (N1, Mr)),
        "gather_calls_transfer": 1}
    # the Schwarz smoother: the multiplicities at build, then the
    # element rows and the gather-sum at each application
    A_e = torch.eye(nn * c, dtype=torch.float64).repeat(E, 1, 1)
    pc = _counted(lambda: build_additive_schwarz(
        A_e, op.elem_nodes, op.amap_idx, op.inv_mult, s.bh.mask))
    assert pc == {"gather_bytes_smoother": 8 * E * nn + _nb((E, nn)),
                  "gather_calls_smoother": 1}
    pre = build_additive_schwarz(A_e, op.elem_nodes, op.amap_idx,
                                 op.inv_mult, s.bh.mask)
    assert _counted(lambda: pre.apply(u)) == {
        "gather_bytes_smoother": _nb((E, nn, c), (E, nn), (N, M, c), (N, M)),
        "gather_calls_smoother": 2}


def test_lattice_gathers_are_the_transfers_and_the_source_rows():
    """On a lattice the operator's element rows are strided windows, not
    counted; its source rows and the injection, prolongation and
    restriction are index gathers."""
    s = _lattice()
    op, lvl = s.op, s.mg_levels[1]
    N, c, E = op.n_nodes, op.nc, op.space.n_elements
    N1 = lvl.mask.shape[0]
    u = torch.rand((N, c), dtype=torch.float64)
    assert _counted(lambda: op._rows(u)) == {}
    assert _counted(lambda: op._fq_rows(op.qpts_phys)) == {
        "gather_bytes_operator": _nb((E, op.n_q, 3), (E,)),
        "gather_calls_operator": 1}
    assert _counted(lambda: lvl.down(u)) == {
        "gather_bytes_transfer": _nb((N1, c), (N1,)),
        "gather_calls_transfer": 1}
    Mp, Mr = lvl.masters.shape[1], lvl.restrict_idx.shape[1]
    assert _counted(lambda: prolong(lvl, u[:N1])) == {
        "gather_bytes_transfer": _nb((N, Mp, c), (N, Mp)),
        "gather_calls_transfer": 1}
    assert _counted(lambda: restrict(lvl, u)) == {
        "gather_bytes_transfer": _nb((N1, Mr, c), (N1, Mr)),
        "gather_calls_transfer": 1}


def test_span_timer_sections_are_spans():
    timer = spans.SpanTimer()
    with timer.section("setup_mesh"):
        pass

    def solve():
        with timer.section("solve"):
            pass

    _, events = _profiled(solve)
    assert "solve" in {name for name, _, _ in events}
    assert [n for _, n in timer.sections.values()] == [1, 1]
    plain = SectionTimer(sections=dict(timer.sections))
    assert timer.report() == plain.report()


def test_setup_sections_are_timed():
    s = _forest()
    assert {"setup_mesh", "setup_space", "setup_operator",
            "setup_levels"} <= set(s.timer.sections)
    assert s.timer.sections["setup_levels"][1] == 2    # and the rebuild
