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
with it.  ``gmres_fixed``, the multigrid cycle's inner solve, runs a
fixed number of steps with that algebra on the device and reads nothing
back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spans import span


class HostSync:
    """Device-to-host reads: each one waits for the device to finish
    the work queued before it."""

    def __init__(self):
        self.count = 0

    def __call__(self, t):
        """A 0-d tensor -> float, or a 1-d tensor -> float64 numpy."""
        self.count += 1
        with span("sync", "sync_wait_s"):
            if t.ndim == 0:
                return float(t.item())
            return t.detach().to("cpu", torch.float64).numpy()


def _identity(x):
    return x


def _reduce(x, reduce_fn):
    return x if reduce_fn is None else reduce_fn(x)


def norm(a, reduce_fn=None):
    """||a||_2 of a tensor, or of a sharded vector with ``reduce_fn``."""
    return torch.sqrt(_reduce((a * a).sum(), reduce_fn))


def _zeros_like(b):
    return torch.zeros_like(b) if isinstance(b, torch.Tensor) \
        else b.zeros_like()


def _rows(b, k: int, zero: bool = False):
    """Storage for ``k`` vectors shaped as the flat vector ``b``."""
    if isinstance(b, torch.Tensor):
        size = (k, b.shape[0])
        return b.new_zeros(size) if zero else b.new_empty(size)
    return b.rows(k, zero)


def _cgs2(Vj, w, reduce_fn):
    """CGS2: two passes of projection of ``w`` against the rows of
    ``Vj``; returns (the projected w, the sum of both passes'
    coefficients, ||w||)."""
    h1 = _reduce(Vj @ w, reduce_fn)
    w = w - h1 @ Vj
    h2 = _reduce(Vj @ w, reduce_fn)
    w = w - h2 @ Vj
    return w, h1 + h2, norm(w, reduce_fn)


def _back_substitute(R, g):
    """Solve upper-triangular R y = g (float64 numpy)."""
    n = g.shape[0]
    y = np.zeros(n)
    for i in range(n - 1, -1, -1):
        y[i] = (g[i] - R[i, i + 1:] @ y[i + 1:]) / R[i, i]
    return y


def gmres(matvec, b, x0=None, *, precond=None, m: int = 30,
          max_restarts: int = 10, atol: float = 1e-12,
          flexible: bool = False, sync: HostSync | None = None,
          reduce_fn=None):
    """Solve A x = b with restarted right-preconditioned GMRES(m).

    matvec:    v -> A v              (flat vectors [n])
    precond:   v -> M^{-1} v         (defaults to identity)
    atol:      absolute residual-norm target
    flexible:  FGMRES — store the preconditioned vectors Z_j so the
               preconditioner may vary between applications
    reduce_fn: the cross-shard sum of inner products (None on one
               device)

    Returns (x, rnorm, iterations, cycles); ``rnorm`` is the Givens
    estimate, ``cycles`` the number of Arnoldi cycles run (each after the
    first reads the restart residual's norm back once).
    """
    precond = precond or _identity
    sync = sync if sync is not None else HostSync()
    with span("krylov.solve"):
        x = _zeros_like(b) if x0 is None else x0
        with span("krylov.matvec"):
            r = b - matvec(x)
        rnorm = sync(norm(r, reduce_fn))
        iters = 0
        restarts = 0
        while rnorm > atol and restarts < max_restarts:
            if restarts > 0:
                with span("krylov.matvec"):
                    r = b - matvec(x)
                beta = sync(norm(r, reduce_fn))
            else:
                beta = rnorm
            V = _rows(b, m + 1)
            V[0] = r / max(beta, 1e-300)
            Z = _rows(b, m) if flexible else None
            Hc = np.zeros((m + 1, m))
            cs = np.zeros(m)
            sn = np.zeros(m)
            g = np.zeros(m + 1)
            g[0] = beta
            j = 0
            rn = beta
            while j < m and rn > atol:
                with span("krylov.arnoldi"):
                    z = precond(V[j])
                    if flexible:
                        Z[j] = z
                    with span("krylov.matvec"):
                        w = matvec(z)
                    with span("krylov.orthogonalize"):
                        w, h12, hnorm = _cgs2(V[:j + 1], w, reduce_fn)
                    col = sync(torch.cat([h12, hnorm[None]]))
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
        return x, rnorm, iters, restarts


def gmres_fixed(matvec, b, x0=None, *, precond=None, m: int = 4,
                flexible: bool = False, reduce_fn=None):
    """One cycle of ``m`` right-preconditioned (F)GMRES steps that reads
    nothing back from the device: the multigrid smoother, bottom solve
    and K-cycle, where the JAX package calls its GMRES with
    ``max_restarts=1, atol=1e-30`` and so runs all ``m`` steps unless
    the residual is exactly zero.

    The Hessenberg matrix stays on the device; its Givens rotations run
    once after the Arnoldi loop, and a step counts only while the
    residual before it is above 1e-30 (as the JAX loop stops), so a
    zero right-hand side or a breakdown yields no update instead of a
    division by zero.  Returns x.
    """
    with span("krylov.fixed"):
        atol = 1e-30
        precond = precond or _identity
        x = _zeros_like(b) if x0 is None else x0
        r = b if x0 is None else b - matvec(x0)
        tiny = 1e-300 if b.dtype == torch.float64 else 1e-30
        beta = norm(r, reduce_fn)
        V = _rows(b, m + 1, zero=True)
        V[0] = r / torch.clamp_min(beta, tiny)
        Z = _rows(b, m) if flexible else None
        small = dict(dtype=b.dtype, device=b.device)
        H = torch.zeros((m + 1, m), **small)
        for j in range(m):
            z = precond(V[j])
            if flexible:
                Z[j] = z
            with span("krylov.matvec"):
                w = matvec(z)
            with span("krylov.orthogonalize"):
                w, h, hnext = _cgs2(V[:j + 1], w, reduce_fn)
            V[j + 1] = w / torch.clamp_min(hnext, tiny)
            H[:j + 1, j] = h
            H[j + 1, j] = hnext
        # Givens rotations, in the order the JAX loop applies them
        g = torch.zeros(m + 1, **small)
        g[0] = beta
        before = [beta]                  # residual before each step
        for j in range(m):
            a, c_ = H[j, j], H[j + 1, j]
            denom = torch.sqrt(a * a + c_ * c_)
            pos = denom > 0
            cs = torch.where(pos, a / torch.clamp_min(denom, tiny),
                             torch.ones_like(a))
            sn = torch.where(pos, c_ / torch.clamp_min(denom, tiny),
                             torch.zeros_like(a))
            rot = torch.stack([torch.stack([cs, sn]),
                               torch.stack([-sn, cs])])
            H[j:j + 2, j:] = rot @ H[j:j + 2, j:]
            g[j:j + 2] = rot @ g[j:j + 2]
            before.append(torch.abs(g[j + 1]))
        active = torch.cumprod(
            (torch.stack(before[:m]) > atol).to(b.dtype), dim=0) > 0
        both = active[:, None] & active[None, :]
        zero, one = torch.zeros_like(g[:m]), torch.ones_like(g[:m])
        R = (torch.where(both, H[:m].triu(), torch.zeros_like(H[:m]))
             + torch.diag(torch.where(active, zero, one)))
        rhs = torch.where(active, g[:m], zero)
        y = torch.linalg.solve_triangular(R, rhs[:, None],
                                          upper=True)[:, 0]
        if flexible:
            return x + y @ Z
        return x + precond(y @ V[:m])


def bicgstab(matvec, b, x0=None, *, precond=None, max_iters: int = 1000,
             atol: float = 1e-12, sync: HostSync | None = None,
             reduce_fn=None):
    """Right-preconditioned BiCGStab (reference: solve_system_BiCGStab).
    Returns (x, rnorm, iterations)."""
    precond = precond or _identity
    sync = sync if sync is not None else HostSync()
    x = _zeros_like(b) if x0 is None else x0
    tiny = 1e-300

    def safe(a):
        return torch.where(a == 0, torch.full_like(a, tiny), a)

    def dot(a, c):
        return _reduce((a * c).sum(), reduce_fn)

    r = b - matvec(x)
    rhat = r
    p = _zeros_like(b)
    v = _zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho, alpha, omega = one, one, one
    rnorm = sync(norm(r, reduce_fn))
    k = 0
    while rnorm > atol and k < max_iters:
        rho_new = dot(rhat, r)
        beta = (rho_new / safe(rho)) * (alpha / safe(omega))
        p = r + beta * (p - omega * v)
        ph = precond(p)
        v = matvec(ph)
        alpha = rho_new / safe(dot(rhat, v))
        s_vec = r - alpha * v
        sh = precond(s_vec)
        t = matvec(sh)
        omega = dot(t, s_vec) / safe(dot(t, t))
        x = x + alpha * ph + omega * sh
        r = s_vec - omega * t
        rho = rho_new
        rnorm = sync(norm(r, reduce_fn))
        k += 1
    return x, rnorm, k
