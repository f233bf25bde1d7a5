"""The PyTorch package's expressions, Krylov solvers, Newton driver and
MMS source against the JAX package, on the same float64 inputs.

Mirrors ``tests/test_expressions.py`` and ``tests/test_linalg.py``: each
case runs through both packages and the results must agree (1e-12
relative for evaluations, the same iteration counts for the solvers,
whose arithmetic is the same up to summation order).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softx_2020_200_tpu.core import expressions as jax_expr
from softx_2020_200_tpu.ops import linalg as jax_linalg
from softx_2020_200_tpu.solvers import analytical as jax_analytical
from softx_2020_200_tpu.solvers import newton as jax_newton
from softx_2020_200_tpu_torch.core import expressions as port_expr
from softx_2020_200_tpu_torch.ops import linalg as port_linalg
from softx_2020_200_tpu_torch.solvers import analytical as port_analytical
from softx_2020_200_tpu_torch.solvers import newton as port_newton

torch.set_num_threads(1)

RTOL = 1e-12

# (source, variables) as in tests/test_expressions.py, plus the deck
# expressions of the examples (functions, powers, conditionals)
EXPRESSIONS = [
    ("1 + 2*3", {}), ("(1+2)*3", {}), ("2^3^2", {}), ("-2^2", {}),
    ("6/3/2", {}), ("1e-3 * 2", {}),
    ("sin(pi/2)", {}), ("cos(0) + exp(0)", {}), ("sqrt(2)^2", {}),
    ("atan2(1, 1)", {}), ("max(3, min(10, 5))", {}), ("abs(-3.5)", {}),
    ("if(x > 0, 1, -1)", {"x": [2.0, -2.0, 0.0]}),
    ("if(x >= 0 && x <= 1, x, 0)", {"x": [0.25, -1.0, 2.0]}),
    ("if(x < 0 || x > 1, 1, 0)", {"x": [0.5, -0.5, 1.5]}),
    ("x*y + t", {"x": [0.0, 1.0, 2.0], "y": [2.0, 2.0, 2.0], "t": 1.0}),
    ("if(y > 0.999, 1, 0)", {"y": [1.0, 0.5]}),
    ("exp(-t)*y*y", {"y": [0.3, 0.7], "t": 0.2}),
    ("0.00222222222222*(x*x+y*y) - 0.00444444444444*log(x*x+y*y)",
     {"x": [0.3, 0.9], "y": [0.4, -0.2]}),
    ("pow(x, 1.5) + x^0.5 + log10(x) + log2(x) + tanh(x) + sign(-x)",
     {"x": [0.5, 2.0]}),
    ("floor(x) + ceil(x) + asin(x/4) + acos(x/4) + atan(x)",
     {"x": [0.5, 2.5]}),
]


@pytest.mark.parametrize("src,env", EXPRESSIONS, ids=[e[0] for e in
                                                      EXPRESSIONS])
def test_expression_matches_jax(src, env):
    want = np.asarray(jax_expr.Expression(src)(
        **{k: jnp.asarray(v) for k, v in env.items()}))
    got = port_expr.Expression(src)(
        **{k: torch.as_tensor(v, dtype=torch.float64)
           for k, v in env.items()})
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-15)


@pytest.mark.parametrize("src,exc", [("1 +", ValueError),
                                     ("foo(1)", ValueError),
                                     ("q + 1", NameError)])
def test_expression_errors_match_jax(src, exc):
    for mod, arr in ((jax_expr, jnp.asarray), (port_expr, torch.tensor)):
        with pytest.raises(exc):
            mod.Expression(src)(x=arr(1.0))


def test_spatial_and_vector_expressions_match_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0.1, 1.0, (7, 5, 2))
    for src in ("x + 10*y", "z + 1", "sin(pi*x) * cos(pi*y) + t"):
        want = jax_expr.Expression(src).spatial(jnp.asarray(pts), 0.7)
        got = port_expr.Expression(src).spatial(torch.as_tensor(pts), 0.7)
        assert tuple(got.shape) == (7, 5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=1e-15)
    src = "x ; -y; 0; x*y*t"
    want = jax_expr.VectorExpression(src, 4).spatial(jnp.asarray(pts), 2.0)
    got = port_expr.VectorExpression(src, 4).spatial(torch.as_tensor(pts),
                                                     2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-15)


@pytest.mark.parametrize("dim", [2, 3])
def test_mms_source_matches_jax(dim):
    exact = ("exp(-t)*y*y; sin(x)*z; cos(y)*x; exp(-t)*x*y*z" if dim == 3
             else "exp(-t)*y*y*x; sin(x)*y; exp(-t)*x*x")
    rng = np.random.default_rng(dim)
    pts = rng.uniform(0.1, 1.0, (4, 3, dim))
    want = jax_analytical.mms_source(jax_expr.VectorExpression(exact), 0.1,
                                     dim)(jnp.asarray(pts), 0.3)
    got = port_analytical.mms_source(port_expr.VectorExpression(exact), 0.1,
                                     dim)(torch.as_tensor(pts), 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-14)


# ----------------------------------------------------------------------
# Krylov solvers (tests/test_linalg.py)
# ----------------------------------------------------------------------
def _system(n=60, seed=0, spd=False, scale_rows=False):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) / np.sqrt(n)
    A = A @ A.T + 2 * np.eye(n) if spd else A + 3 * np.eye(n)
    if scale_rows:
        A = A * np.geomspace(1, 1000, n)[:, None]
    return A, A @ rng.standard_normal(n)


KRYLOV = {
    "gmres": dict(system=dict(), kw=dict(m=30, max_restarts=10, atol=1e-10)),
    "gmres_restarted": dict(system=dict(n=80, seed=1),
                            kw=dict(m=10, max_restarts=40, atol=1e-9)),
    "gmres_jacobi": dict(system=dict(n=100, seed=2, spd=True,
                                     scale_rows=True),
                         kw=dict(m=50, max_restarts=20, atol=1e-8),
                         jacobi=True),
    "fgmres_jacobi": dict(system=dict(n=100, seed=2, spd=True,
                                      scale_rows=True),
                          kw=dict(m=20, max_restarts=20, atol=1e-8,
                                  flexible=True), jacobi=True),
    "gmres_zero_rhs": dict(system=dict(), kw=dict(atol=1e-12), zero=True),
    "bicgstab": dict(system=dict(n=50, seed=3),
                     kw=dict(atol=1e-10, max_iters=500)),
}


@pytest.mark.parametrize("case", sorted(KRYLOV))
def test_krylov_matches_jax(case):
    spec = KRYLOV[case]
    A, b = _system(**spec["system"])
    if spec.get("zero"):
        b = np.zeros_like(b)
    name = "bicgstab" if case == "bicgstab" else "gmres"
    kw = dict(spec["kw"])
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    if spec.get("jacobi"):
        diag = np.array(np.diag(A))
        dj, dt = jnp.asarray(diag), torch.as_tensor(diag)
        kw_j = dict(kw, precond=lambda v: v / dj)
        kw_t = dict(kw, precond=lambda v: v / dt)
    else:
        kw_j = kw_t = kw
    xj, rj, itj = getattr(jax_linalg, name)(lambda v: Aj @ v, bj, **kw_j)
    sync = port_linalg.HostSync()
    out = getattr(port_linalg, name)(lambda v: At @ v, bt, sync=sync,
                                     **kw_t)
    xt, rt, itt = out[:3]
    assert itt == int(itj)
    assert rt <= kw["atol"] or itt == 0
    scale = max(float(np.abs(np.asarray(xj)).max()), 1e-300)
    assert float(np.abs(xt.numpy() - np.asarray(xj)).max()) / scale < 1e-9
    if spec.get("zero"):
        assert itt == 0 and float(xt.abs().max()) == 0.0
    else:
        np.testing.assert_allclose(At.numpy() @ xt.numpy(), b,
                                   atol=10 * kw["atol"])
    # one host read for the first residual, one per Arnoldi / BiCGStab
    # step and one per GMRES restart (gmres also returns its cycles)
    restarts = max(out[3] - 1, 0) if name == "gmres" else 0
    assert sync.count == 1 + itt + restarts


# ----------------------------------------------------------------------
# Newton (tests/test_linalg.py)
# ----------------------------------------------------------------------
def test_newton_stops_at_noise_floor_like_jax():
    """A residual with an O(eps) noise term the tangent cannot see: both
    drivers stop at the floor after the same iterations (stall guard)
    and return the best iterate."""
    eps = 1e-6
    b = np.linspace(0.7, 1.3, 8)[:, None]
    bj, bt = jnp.asarray(b), torch.as_tensor(b)

    @jax.custom_jvp
    def res_j(u):
        return (u - bj) + eps * jnp.sin(u / eps)

    @res_j.defjvp
    def _jvp(primals, tangents):
        return res_j(primals[0]), tangents[0]

    def res_t(u):
        return (u - bt) + eps * torch.sin(u / eps)

    kw = dict(tolerance=1e-12, max_iterations=60, relative_residual=1e-6)
    rj = jax_newton.newton_solve(
        res_j, jnp.zeros_like(bj), precond_builder=lambda u: (lambda v: v),
        config=jax_newton.NewtonConfig(**kw))
    rt = port_newton.newton_solve(
        res_t, lambda u: (lambda v: v), torch.zeros_like(bt),
        precond_builder=lambda u: (lambda v: v),
        config=port_newton.NewtonConfig(**kw))
    assert rt.n_iterations == int(rj.n_iterations) < 45
    np.testing.assert_allclose(rt.res_history, np.asarray(rj.res_history),
                               rtol=1e-6)
    rn_ret = float(torch.linalg.vector_norm(res_t(rt.u)))
    assert rn_ret <= 1.001 * np.nanmin(rt.res_history)


@pytest.mark.parametrize("method", ["gmres", "bicgstab"])
def test_newton_healthy_solve_like_jax(method):
    b = np.linspace(0.5, 1.5, 6)[:, None]
    bj, bt = jnp.asarray(b), torch.as_tensor(b)
    kw = dict(tolerance=1e-10, max_iterations=30, relative_residual=1e-10,
              method=method)
    rj = jax_newton.newton_solve(
        lambda u: u ** 3 + u - bj, jnp.zeros_like(bj),
        precond_builder=lambda u: (lambda v: v),
        config=jax_newton.NewtonConfig(**kw))
    rt = port_newton.newton_solve(
        lambda u: u ** 3 + u - bt, lambda u: (lambda v: (3 * u ** 2 + 1) * v),
        torch.zeros_like(bt), precond_builder=lambda u: (lambda v: v),
        config=port_newton.NewtonConfig(**kw))
    assert rt.n_iterations == int(rj.n_iterations)
    assert rt.res_history[rt.n_iterations] <= 1e-10
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=1e-12)
    # host syncs: the initial norm, then one per GMRES/BiCGStab step and
    # per line-search evaluation
    assert rt.host_syncs >= 1 + 2 * rt.n_iterations


def test_skip_newton_state_reuse():
    """Skip-Newton rebuilds the preconditioner state every
    ``skip_iterations`` iterations and converges to the same answer."""
    b = torch.as_tensor(np.linspace(0.5, 1.5, 6)[:, None])
    built = []

    def state_fn(u):
        built.append(1)
        return 1.0 / (3 * u ** 2 + 1)

    res = port_newton.newton_solve(
        lambda u: u ** 3 + u - b, lambda u: (lambda v: (3 * u ** 2 + 1) * v),
        torch.zeros_like(b), precond_state_fn=state_fn,
        precond_apply_fn=lambda s, v: s * v,
        config=port_newton.NewtonConfig(tolerance=1e-10, max_iterations=30,
                                        relative_residual=1e-10,
                                        skip_iterations=3))
    assert res.res_history[res.n_iterations] <= 1e-10
    assert len(built) == math.ceil(res.n_iterations / 3)
