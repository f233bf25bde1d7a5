"""The PyTorch package's geometric multigrid against the JAX package's, on
the CPU in float64 with the same inputs made with numpy.

- the lattice hierarchy (level sizes, Dirichlet masks, interpolation
  masters/weights, injection) for a Q1 and a Q2 lattice;
- one cycle application, linearized at the same state, for the jacobi and
  krylov smoothers and v, w and k cycles (1e-10 relative);
- the fixed-step device GMRES against the JAX GMRES it stands in for;
- a steady solve with ``auto`` (GMG, FGMRES): the same solution (1e-8)
  and FGMRES count (within 1);
- a cycle application reads nothing back from the device;
- the stagnation fallback to block-Jacobi and the one-time probation.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softx_2020_200_tpu.core.parameters import \
    SimulationParameters as JaxParameters
from softx_2020_200_tpu.ops import linalg as jax_linalg
from softx_2020_200_tpu.ops import multigrid as jax_mg
from softx_2020_200_tpu.solvers.base import \
    GLSNavierStokesSolver as JaxSolver
from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
from softx_2020_200_tpu_torch.ops import multigrid as port_mg
from softx_2020_200_tpu_torch.ops.linalg import gmres_fixed
from softx_2020_200_tpu_torch.solvers.base import GLSNavierStokesSolver

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a lid-driven cavity on a lattice: noslip walls, a moving lid
CAVITY = """
subsection simulation control
  set method = steady
  set output path = {out}/
end
subsection physical properties
  set kinematic viscosity = 0.1
end
subsection FEM
  set velocity order = {degree}
  set pressure order = {degree}
end
subsection mesh
  set type = dealii
  set grid type = hyper_cube
  set grid arguments = 0 : 1 : true
  set initial refinement = {refine}
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
  set tolerance = 1e-9
  set max iterations = {newton}
end
subsection linear solver
  set verbosity = quiet
  set relative residual = {rel}
  set max krylov vectors = {krylov}
  set max iters = {krylov}
end
"""


def _cavity(tmp_path, degree=1, refine=3, newton=10, rel=1e-4, krylov=100):
    return CAVITY.format(out=tmp_path, degree=degree, refine=refine,
                         newton=newton, rel=rel, krylov=krylov)


def _pair(text):
    ja = JaxSolver(JaxParameters.from_text(text, dim=2))
    po = GLSNavierStokesSolver(SimulationParameters.from_text(text, dim=2),
                               device="cpu", dtype=torch.float64)
    return ja, po


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


# (degree, refinement): a Q1 lattice 8^2 -> 4^2 -> 2^2, and a Q2 lattice
# 4^2 -> Q1 4^2 -> Q1 2^2, with min_elems = 4 so that small lattices
# have three levels
HIERARCHIES = [(1, 3), (2, 2)]


@pytest.mark.parametrize("degree,refine", HIERARCHIES)
def test_hierarchy_matches_jax(degree, refine, tmp_path):
    ja, po = _pair(_cavity(tmp_path, degree, refine))
    ops_a, mg_a = jax_mg.build_hierarchy(ja, min_elems=4)
    levels = port_mg.build_hierarchy(po, min_elems=4)
    assert len(levels) == len(ops_a) == 3
    for li, (lvl, oa, ma) in enumerate(zip(levels, ops_a, mg_a)):
        assert lvl.op.n_nodes == oa.n_nodes
        assert lvl.op.n_q == oa.n_q and lvl.op.degree == oa.degree
        assert lvl.op.layout is not None
        np.testing.assert_array_equal(lvl.mask.numpy(),
                                      np.asarray(ma["bh_mask"]))
        if li == 0:
            continue
        np.testing.assert_array_equal(lvl.masters.numpy(),
                                      np.asarray(ma["masters"]))
        np.testing.assert_array_equal(lvl.weights.numpy(),
                                      np.asarray(ma["weights"]))
        np.testing.assert_array_equal(lvl.inject.numpy(),
                                      np.asarray(ma["inject"]))


@pytest.mark.parametrize("smoother", ["jacobi", "krylov"])
@pytest.mark.parametrize("cycle", ["v", "w", "k"])
def test_cycle_matches_jax(smoother, cycle, tmp_path):
    ja, po = _pair(_cavity(tmp_path, degree=1, refine=3))
    ops_a, mg_a = jax_mg.build_hierarchy(ja, min_elems=4)
    levels = port_mg.build_hierarchy(po, min_elems=4)
    kw = dict(smoother=smoother, cycle=cycle, coarse_iters=6, krylov_m=3)
    build_a = jax_mg.make_vcycle(ops_a, **kw)
    build_p = port_mg.make_vcycle(levels, **kw)

    rng = np.random.default_rng(3)
    N, c = po.space.n_nodes, 3
    E, nq = po.space.n_elements, po.op.n_q
    u = rng.standard_normal((N, c)) * 0.3
    prev = rng.standard_normal((N, 2)) * 0.2
    fq = rng.standard_normal((E, nq, 2))
    v = rng.standard_normal((N, c))
    mask = np.array(ja.bh.mask)
    a0, sdt = 10.0, 10.0

    z_ref = jax.jit(lambda u_, v_, mg: build_a(
        u_, jnp.asarray(prev), jnp.asarray(fq), a0, sdt,
        jnp.asarray(mask), mg)(v_))(jnp.asarray(u), jnp.asarray(v), mg_a)
    t = torch.as_tensor
    z = build_p(t(u), t(prev), t(fq), a0, sdt, t(mask))(t(v))
    assert _rel(z, z_ref) < 1e-10


@pytest.mark.parametrize("flexible", [False, True])
def test_fixed_gmres_matches_jax(flexible):
    """m steps from x0; a zero right-hand side gives zero (the breakdown
    at the first step is masked, as the JAX loop never enters it)."""
    rng = np.random.default_rng(1)
    n, m = 40, 7
    A = np.eye(n) * 4 + rng.standard_normal((n, n)) * 0.3
    d = 1.0 / np.diag(A)
    b = rng.standard_normal(n)
    x0 = rng.standard_normal(n) * 0.1
    ref, _, iters = jax_linalg.gmres(
        lambda x: jnp.asarray(A) @ x, jnp.asarray(b), x0=jnp.asarray(x0),
        precond=lambda x: jnp.asarray(d) * x, m=m, max_restarts=1,
        atol=1e-30, flexible=flexible)
    assert int(iters) == m
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    x = gmres_fixed(lambda x: At @ x, torch.as_tensor(b),
                    x0=torch.as_tensor(x0), precond=lambda x: dt * x, m=m,
                    flexible=flexible)
    assert _rel(x, ref) < 1e-12
    z = gmres_fixed(lambda x: At @ x, torch.zeros(n, dtype=torch.float64),
                    precond=lambda x: dt * x, m=m, flexible=flexible)
    np.testing.assert_array_equal(z.numpy(), np.zeros(n))


def test_steady_gmg_solve_matches_jax(tmp_path):
    """The golden periodic Q2 deck (steady, auto): GMG on Q2 8^2 -> Q1
    8^2 with the krylov smoother, FGMRES outside."""
    with open(os.path.join(ROOT, "tests", "golden", "periodic_gls.prm")) as f:
        text = f.read().replace(
            "subsection simulation control\n",
            f"subsection simulation control\n  set output path = {tmp_path}/\n")
    ja, po = _pair(text)
    assert po.precond_kind == ja.precond_kind == "gmg"
    assert po.newton_cfg.flexible and ja.newton_cfg.flexible
    assert len(po.mg_levels) == len(ja._mg_ops) == 2
    ua, ra = ja.solve_steady(verbose=False)
    up, rp = po.solve_steady(verbose=False)
    assert _rel(up, ua) < 1e-8
    assert rp.n_iterations == int(ra.n_iterations)
    assert abs(rp.linear_iters - int(ra.linear_iters)) <= 1
    # the host reads are the solver loop's own (chip_smoke.py phase 6
    # holds the card to the same count): the first residual, each
    # FGMRES solve's first residual, one per FGMRES step, one per Krylov
    # restart and one per line-search evaluation; the cycle adds none
    assert rp.host_syncs == (1 + rp.n_iterations + rp.linear_iters
                             + rp.linear_restarts + rp.line_search_evals)


@contextlib.contextmanager
def _host_reads():
    """Counts every tensor-to-host conversion (item, bool, float, int,
    index, tolist, numpy, cpu) while it is active."""
    count = [0]
    names = ["item", "tolist", "numpy", "cpu", "__bool__", "__float__",
             "__int__", "__index__"]
    orig = {n: getattr(torch.Tensor, n) for n in names}

    def counted(fn):
        def wrapper(self, *args, **kwargs):
            count[0] += 1
            return fn(self, *args, **kwargs)
        return wrapper

    for n in names:
        setattr(torch.Tensor, n, counted(orig[n]))
    try:
        yield count
    finally:
        for n in names:
            setattr(torch.Tensor, n, orig[n])


@pytest.mark.parametrize("cycle", ["v", "k"])
def test_cycle_reads_nothing_back(cycle, tmp_path):
    _, po = _pair(_cavity(tmp_path, degree=2, refine=2))
    levels = port_mg.build_hierarchy(po, min_elems=4)
    builder = port_mg.make_vcycle(levels, smoother="krylov", cycle=cycle)
    rng = np.random.default_rng(5)
    u = torch.as_tensor(rng.standard_normal((po.space.n_nodes, 3)))
    apply = builder(u, po._zero_prev, po._source_at(0.0), 0.0, 0.0,
                    po.bh.mask)
    v = torch.as_tensor(rng.standard_normal(u.shape))
    with _host_reads() as reads:
        z = apply(v)
    assert reads[0] == 0
    assert bool(torch.isfinite(z).all())
    with _host_reads() as reads:
        float(z.sum())
    assert reads[0] == 1            # the counter sees a read


def test_fallback_and_probation(tmp_path, capsys):
    """A linear budget GMG cannot meet: the first stall swaps in
    block-Jacobi for the rest of the solve (strike 1); the next solve
    restores GMG once and stalls again (strike 2), after which the swap
    stays, across a rebuild too."""
    text = _cavity(tmp_path, degree=1, refine=5, newton=2, rel=1e-12,
                   krylov=2)
    po = GLSNavierStokesSolver(SimulationParameters.from_text(text, dim=2),
                               device="cpu", dtype=torch.float64)
    assert po.precond_kind == "gmg" and len(po.mg_levels) == 2
    u0 = po.initial_condition()
    msg = "GMG stagnated (linear budget exhausted)"

    po._newton(u0, po._zero_prev, 0.0, 0.0, 0.0)
    assert capsys.readouterr().out.count(msg) == 1
    assert po.precond_kind == "block_jacobi" and po._gmg_strikes == 1

    po._newton(u0, po._zero_prev, 0.0, 0.0, 0.0)     # probation
    assert capsys.readouterr().out.count(msg) == 1
    assert po.precond_kind == "block_jacobi" and po._gmg_strikes == 2

    po._newton(u0, po._zero_prev, 0.0, 0.0, 0.0)     # evicted for good
    assert msg not in capsys.readouterr().out
    assert po.precond_kind == "block_jacobi" and po._gmg_strikes == 2

    po.setup()
    out = capsys.readouterr().out
    assert "GMG stays evicted on the adapted mesh (2 stagnation strikes)" \
        in out
    assert po.precond_kind == "block_jacobi" and po._vcycle is None
