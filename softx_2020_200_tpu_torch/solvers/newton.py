"""Newton nonlinear driver with line search (counterpart of
``softx_2020_200_tpu.solvers.newton``).

Loop { build preconditioner; solve J d = -R matrix-free; alpha-halving
line search on ||R||; update } until ||R|| < tol, with the JAX package's
stall guard, best-iterate tracking and skip-Newton.  The loop runs on the
host: every convergence check reads one number from the device, and the
driver counts those reads (``NewtonResult.host_syncs``).

``reduce_fn`` is the JAX package's cross-shard hook: over shards
(``parallel/sharded.py``) the state is a ``ShardVec`` and ``reduce_fn``
adds the shards' partial sums of every norm and Krylov inner product.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core.spans import span
from ..ops.linalg import HostSync, bicgstab, gmres, norm


@dataclass(frozen=True)
class NewtonConfig:
    tolerance: float = 1e-6
    max_iterations: int = 10
    max_halvings: int = 4
    # linear solver
    method: str = "gmres"            # gmres | bicgstab
    gmres_restart: int = 50
    max_krylov_cycles: int = 20
    relative_residual: float = 1e-3
    minimum_residual: float = 1e-10
    # preconditioner refresh cadence (1 = every iteration; >1 = skip-Newton)
    skip_iterations: int = 1
    # floating-point floor stagnation: stop when the last `stall_window`
    # Newton steps together reduced ||R|| by less than a factor
    # 1/`stall_factor` (the f32 residual floor; see the JAX package)
    stall_window: int = 4
    stall_factor: float = 0.9
    # FGMRES (required when the preconditioner itself iterates, e.g. the
    # multigrid bottom-level Krylov solve)
    flexible: bool = False


class NewtonResult(NamedTuple):
    u: torch.Tensor
    res_history: np.ndarray      # [max_iterations+1] residual norms (nan-pad)
    n_iterations: int
    linear_iters: int
    alphas: np.ndarray           # line-search alpha per iteration
    host_syncs: int              # device-to-host reads during the solve
    line_search_evals: int       # residual evaluations of the line search
    linear_restarts: int         # Krylov restarts (one read each)


def linear_solve(jv, precond, R, rnorm: float, config: NewtonConfig,
                 sync: HostSync, reduce_fn=None):
    """The Newton direction: solve J d = -R to ``max(relative_residual *
    rnorm, minimum_residual)`` with ``jv`` (v[N, c] -> J v) and
    ``precond`` (v[N, c] -> M^-1 v).  Returns (d[N, c], the linear
    residual, its tolerance, iterations, Krylov cycles)."""
    shape = R.shape

    def matvec(v_flat):
        return jv(v_flat.reshape(shape)).reshape(-1)

    def pre_flat(v_flat):
        return precond(v_flat.reshape(shape)).reshape(-1)

    lin_atol = max(config.relative_residual * rnorm,
                   config.minimum_residual)
    if config.method == "bicgstab":
        d, lin_rn, lin_it = bicgstab(
            matvec, -R.reshape(-1), precond=pre_flat,
            max_iters=config.gmres_restart * config.max_krylov_cycles,
            atol=lin_atol, sync=sync, reduce_fn=reduce_fn)
        cycles = 1
    else:
        d, lin_rn, lin_it, cycles = gmres(
            matvec, -R.reshape(-1), precond=pre_flat,
            m=config.gmres_restart,
            max_restarts=config.max_krylov_cycles, atol=lin_atol,
            flexible=config.flexible, sync=sync, reduce_fn=reduce_fn)
    return d.reshape(shape), lin_rn, lin_atol, lin_it, cycles


def line_search(residual_fn, u, d, rnorm: float, config: NewtonConfig,
                sync: HostSync, reduce_fn=None):
    """The alpha-halving line search on ||R(u + alpha d)||: halve while
    the norm does not fall below ``rnorm``, at most ``max_halvings``
    times, and take the last step tried.  Returns (u + alpha d, its
    residual, the norm, alpha, residual evaluations)."""
    with span("newton.line_search"):
        alpha = 1.0
        Rt = residual_fn(u + d)
        nt = sync(norm(Rt, reduce_fn))
        k = 0
        while nt >= rnorm and k < config.max_halvings:
            alpha *= 0.5
            Rt = residual_fn(u + alpha * d)
            nt = sync(norm(Rt, reduce_fn))
            k += 1
        return u + alpha * d, Rt, nt, alpha, 1 + k


def newton_solve(residual_fn: Callable, jacobian_fn: Callable, u0, *,
                 precond_builder: Callable | None = None,
                 config: NewtonConfig,
                 precond_state_fn: Callable | None = None,
                 precond_apply_fn: Callable | None = None,
                 on_linear_stall: Callable[[], bool] | None = None,
                 sync: HostSync | None = None,
                 reduce_fn=None) -> NewtonResult:
    """Solve R(u) = 0.

    residual_fn:     u[N, c] -> R[N, c] (constrained; zero at Dirichlet)
    jacobian_fn:     u[N, c] -> (v[N, c] -> J(u) v), linearized once per
                     Newton iteration
    precond_builder: u[N, c] -> (v[N, c] -> M^{-1} v), rebuilt every
                     iteration

    Skip-Newton: pass ``precond_state_fn(u) -> state`` and
    ``precond_apply_fn(state, v) -> v`` instead; the state is rebuilt
    only every ``config.skip_iterations`` iterations.

    ``on_linear_stall()`` runs when a linear solve ends above its
    tolerance; if it returns True (it changed what ``precond_builder``
    builds) the Newton iteration is retried.

    ``reduce_fn`` (None on one device) adds the shards' partial sums of
    every norm and inner product.
    """
    sync = sync if sync is not None else HostSync()
    start = sync.count
    maxit = config.max_iterations
    skip = max(1, config.skip_iterations)
    stateful = precond_state_fn is not None

    R = residual_fn(u0)
    rnorm = sync(norm(R, reduce_fn))
    hist = np.full(maxit + 1, np.nan)
    alphas = np.full(maxit, np.nan)
    hist[0] = rnorm
    u = u0
    it = lin_total = ls_evals = restarts = 0
    pstate = None
    u_best, n_best = u0, rnorm

    def stalled():
        W = config.stall_window
        return it >= W and rnorm > config.stall_factor * hist[it - W]

    while rnorm > config.tolerance and it < maxit and not stalled():
        with span("newton.iteration"):
            # the last iteration's Jacobian and preconditioner go before
            # the next ones are built: two iterations' linearizations and
            # multigrid states are never alive at once
            jv = precond = None
            with span("newton.linearize"):
                jv = jacobian_fn(u)
            with span("newton.precond_build"):
                if stateful:
                    if pstate is None or it % skip == 0:
                        pstate = precond_state_fn(u)
                    state = pstate
                    precond = lambda v: precond_apply_fn(  # noqa: E731
                        state, v)
                else:
                    precond = precond_builder(u)
            d, lin_rn, lin_atol, lin_it, cycles = linear_solve(
                jv, precond, R, rnorm, config, sync, reduce_fn)
            restarts += max(cycles - 1, 0)
            lin_total += lin_it
            if (lin_rn > lin_atol and on_linear_stall is not None
                    and on_linear_stall()):
                continue
            u, R, rnorm, alpha, evals = line_search(
                residual_fn, u, d, rnorm, config, sync, reduce_fn)
        ls_evals += evals
        alphas[it] = alpha
        it += 1
        hist[it] = rnorm
        # best-iterate tracking: at the floating-point floor the line
        # search may accept a step that grew ||R||; return the best
        # visited iterate
        if rnorm < n_best:
            u_best, n_best = u, rnorm
    return NewtonResult(u=u_best, res_history=hist, n_iterations=it,
                        linear_iters=lin_total, alphas=alphas,
                        host_syncs=sync.count - start,
                        line_search_evals=ls_evals,
                        linear_restarts=restarts)
