"""Newton nonlinear driver with line search (counterpart of
``softx_2020_200_tpu.solvers.newton``).

Loop { build preconditioner; solve J d = -R matrix-free; alpha-halving
line search on ||R||; update } until ||R|| < tol, with the JAX package's
stall guard, best-iterate tracking and skip-Newton.  The loop runs on the
host: every convergence check reads one number from the device, and the
driver counts those reads (``NewtonResult.host_syncs``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.linalg import HostSync, bicgstab, gmres


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


class NewtonResult(NamedTuple):
    u: torch.Tensor
    res_history: np.ndarray      # [max_iterations+1] residual norms (nan-pad)
    n_iterations: int
    linear_iters: int
    alphas: np.ndarray           # line-search alpha per iteration
    host_syncs: int              # device-to-host reads during the solve


def newton_solve(residual_fn: Callable, jacobian_fn: Callable, u0, *,
                 precond_builder: Callable | None = None,
                 config: NewtonConfig,
                 precond_state_fn: Callable | None = None,
                 precond_apply_fn: Callable | None = None,
                 sync: HostSync | None = None) -> NewtonResult:
    """Solve R(u) = 0.

    residual_fn:     u[N, c] -> R[N, c] (constrained; zero at Dirichlet)
    jacobian_fn:     u[N, c] -> (v[N, c] -> J(u) v), linearized once per
                     Newton iteration
    precond_builder: u[N, c] -> (v[N, c] -> M^{-1} v), rebuilt every
                     iteration

    Skip-Newton: pass ``precond_state_fn(u) -> state`` and
    ``precond_apply_fn(state, v) -> v`` instead; the state is rebuilt
    only every ``config.skip_iterations`` iterations.
    """
    sync = sync if sync is not None else HostSync()
    start = sync.count
    shape = u0.shape
    maxit = config.max_iterations
    skip = max(1, config.skip_iterations)
    stateful = precond_state_fn is not None

    def norm(R):
        return torch.sqrt(torch.sum(R * R))

    R = residual_fn(u0)
    rnorm = sync(norm(R))
    hist = np.full(maxit + 1, np.nan)
    alphas = np.full(maxit, np.nan)
    hist[0] = rnorm
    u = u0
    it = lin_total = 0
    pstate = None
    u_best, n_best = u0, rnorm

    def stalled():
        W = config.stall_window
        return it >= W and rnorm > config.stall_factor * hist[it - W]

    while rnorm > config.tolerance and it < maxit and not stalled():
        jv = jacobian_fn(u)

        def matvec(v_flat):
            return jv(v_flat.reshape(shape)).reshape(-1)

        if stateful:
            if pstate is None or it % skip == 0:
                pstate = precond_state_fn(u)
            state = pstate
            precond = lambda v: precond_apply_fn(state, v)  # noqa: E731
        else:
            precond = precond_builder(u)

        def pre_flat(v_flat):
            return precond(v_flat.reshape(shape)).reshape(-1)

        lin_atol = max(config.relative_residual * rnorm,
                       config.minimum_residual)
        if config.method == "bicgstab":
            d, _, lin_it = bicgstab(
                matvec, -R.reshape(-1), precond=pre_flat,
                max_iters=config.gmres_restart * config.max_krylov_cycles,
                atol=lin_atol, sync=sync)
        else:
            d, _, lin_it = gmres(
                matvec, -R.reshape(-1), precond=pre_flat,
                m=config.gmres_restart,
                max_restarts=config.max_krylov_cycles, atol=lin_atol,
                sync=sync)
        d = d.reshape(shape)

        # alpha-halving line search on ||R(u + alpha d)||
        alpha = 1.0
        Rt = residual_fn(u + d)
        nt = sync(norm(Rt))
        k = 0
        while nt >= rnorm and k < config.max_halvings:
            alpha *= 0.5
            Rt = residual_fn(u + alpha * d)
            nt = sync(norm(Rt))
            k += 1

        u = u + alpha * d
        R, rnorm = Rt, nt
        alphas[it] = alpha
        it += 1
        hist[it] = rnorm
        lin_total += lin_it
        # best-iterate tracking: at the floating-point floor the line
        # search may accept a step that grew ||R||; return the best
        # visited iterate
        if rnorm < n_best:
            u_best, n_best = u, rnorm
    return NewtonResult(u=u_best, res_history=hist, n_iterations=it,
                        linear_iters=lin_total, alphas=alphas,
                        host_syncs=sync.count - start)
