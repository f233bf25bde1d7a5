"""Matrix-free Krylov solvers in eager PyTorch (counterpart of
``softx_2020_200_tpu.ops.linalg``).

Restarted right-preconditioned GMRES(m) with CGS2 re-orthogonalization
(two batched products against the Krylov basis per iteration), FGMRES,
and BiCGStab.  Each ``lax.while_loop`` of the JAX package becomes a
Python loop; its condition is read on the host, so every convergence
check waits for the device once.  ``HostSync`` counts those reads.

GMRES keeps the small Hessenberg algebra (Givens rotations, the
triangular solve) on the host in float64: the one read per Arnoldi
step brings the new Hessenberg column, and the residual estimate comes
with it.
"""

from __future__ import annotations

import numpy as np
import torch


class HostSync:
    """Device-to-host reads: each one waits for the device to finish
    the work queued before it."""

    def __init__(self):
        self.count = 0

    def __call__(self, t):
        """A 0-d tensor -> float, or a 1-d tensor -> float64 numpy."""
        self.count += 1
        if t.ndim == 0:
            return float(t.item())
        return t.detach().to("cpu", torch.float64).numpy()


def _identity(x):
    return x


def _norm(a):
    return torch.sqrt(torch.sum(a * a))


def _back_substitute(R, g):
    """Solve upper-triangular R y = g (float64 numpy)."""
    n = g.shape[0]
    y = np.zeros(n)
    for i in range(n - 1, -1, -1):
        y[i] = (g[i] - R[i, i + 1:] @ y[i + 1:]) / R[i, i]
    return y


def gmres(matvec, b, x0=None, *, precond=None, m: int = 30,
          max_restarts: int = 10, atol: float = 1e-12,
          flexible: bool = False, sync: HostSync | None = None):
    """Solve A x = b with restarted right-preconditioned GMRES(m).

    matvec:   v -> A v              (flat vectors [n])
    precond:  v -> M^{-1} v         (defaults to identity)
    atol:     absolute residual-norm target
    flexible: FGMRES — store the preconditioned vectors Z_j so the
              preconditioner may vary between applications

    Returns (x, rnorm, iterations); ``rnorm`` is the Givens estimate.
    """
    precond = precond or _identity
    sync = sync if sync is not None else HostSync()
    x = torch.zeros_like(b) if x0 is None else x0
    n = b.shape[0]
    r = b - matvec(x)
    rnorm = sync(_norm(r))
    iters = 0
    restarts = 0
    while rnorm > atol and restarts < max_restarts:
        if restarts > 0:
            r = b - matvec(x)
            beta = sync(_norm(r))
        else:
            beta = rnorm
        V = b.new_empty((m + 1, n))
        V[0] = r / max(beta, 1e-300)
        Z = b.new_empty((m, n)) if flexible else None
        Hc = np.zeros((m + 1, m))
        cs = np.zeros(m)
        sn = np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = beta
        j = 0
        rn = beta
        while j < m and rn > atol:
            z = precond(V[j])
            if flexible:
                Z[j] = z
            w = matvec(z)
            Vj = V[:j + 1]
            # CGS2: two passes of projection against V[0..j]
            h1 = Vj @ w
            w = w - h1 @ Vj
            h2 = Vj @ w
            w = w - h2 @ Vj
            col = sync(torch.cat([h1 + h2, _norm(w)[None]]))
            hnext = col[-1]
            V[j + 1] = w / max(hnext, 1e-300)
            h = np.zeros(m + 1)
            h[:j + 2] = col
            # apply the stored Givens rotations to the new column
            for i in range(j):
                hi = cs[i] * h[i] + sn[i] * h[i + 1]
                h[i + 1] = -sn[i] * h[i] + cs[i] * h[i + 1]
                h[i] = hi
            denom = np.sqrt(h[j] ** 2 + hnext ** 2)
            c_new = h[j] / denom if denom > 0 else 1.0
            s_new = h[j + 1] / denom if denom > 0 else 0.0
            h[j] = c_new * h[j] + s_new * h[j + 1]
            h[j + 1] = 0.0
            g[j + 1] = -s_new * g[j]
            g[j] = c_new * g[j]
            cs[j], sn[j] = c_new, s_new
            Hc[:, j] = h
            rn = abs(g[j + 1])
            j += 1
        if j:
            y = torch.as_tensor(_back_substitute(Hc[:j, :j], g[:j]),
                                dtype=b.dtype, device=b.device)
            if flexible:
                x = x + y @ Z[:j]
            else:
                x = x + precond(y @ V[:j])
        iters += j
        restarts += 1
        rnorm = rn
    return x, rnorm, iters


def bicgstab(matvec, b, x0=None, *, precond=None, max_iters: int = 1000,
             atol: float = 1e-12, sync: HostSync | None = None):
    """Right-preconditioned BiCGStab (reference: solve_system_BiCGStab).
    Returns (x, rnorm, iterations)."""
    precond = precond or _identity
    sync = sync if sync is not None else HostSync()
    x = torch.zeros_like(b) if x0 is None else x0
    tiny = 1e-300

    def safe(a):
        return torch.where(a == 0, torch.full_like(a, tiny), a)

    r = b - matvec(x)
    rhat = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho, alpha, omega = one, one, one
    rnorm = sync(_norm(r))
    k = 0
    while rnorm > atol and k < max_iters:
        rho_new = torch.sum(rhat * r)
        beta = (rho_new / safe(rho)) * (alpha / safe(omega))
        p = r + beta * (p - omega * v)
        ph = precond(p)
        v = matvec(ph)
        alpha = rho_new / safe(torch.sum(rhat * v))
        s_vec = r - alpha * v
        sh = precond(s_vec)
        t = matvec(sh)
        omega = torch.sum(t * s_vec) / safe(torch.sum(t * t))
        x = x + alpha * ph + omega * sh
        r = s_vec - omega * t
        rho = rho_new
        rnorm = sync(_norm(r))
        k += 1
    return x, rnorm, k
