"""Analytical solutions and L2-error computation (counterpart of
``softx_2020_200_tpu.solvers.analytical``).

The exact (u, p) comes from deck expressions; the L2 error is a
quadrature reduction over elements, with the pressure mean-shifted
before comparison.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from ..core.expressions import VectorExpression
from ..fem.geometry import det_and_inv


def l2_error(op, u, exact: VectorExpression, t=0.0):
    """Return (err_velocity, err_pressure) vs the exact expression.

    op: GLSOperator (tabulations/geometry); u: [N, d+1].
    """
    d = op.dim
    ue = u[op.elem_nodes]
    uq = torch.einsum("qn,enc->eqc", op.B, ue)           # [E, nq, c]
    J = torch.einsum("eni,qnj->eqij", op.xe, op.G)
    detJ, _ = det_and_inv(J)
    wdet = detJ * op.w[None, :]                          # [E, nq]

    exq = exact.spatial(op.qpts_phys, t)                 # [E, nq, >=d+1]
    vol = torch.sum(wdet)

    dv = uq[..., :d] - exq[..., :d]
    err_v = torch.sqrt(torch.sum(wdet[..., None] * dv * dv))

    dp = uq[..., d] - exq[..., d]
    mean = torch.sum(wdet * dp) / vol
    dp = dp - mean
    err_p = torch.sqrt(torch.sum(wdet * dp * dp))
    return err_v, err_p


def mms_source(exact: VectorExpression, nu: float, dim: int):
    """The MMS body force from an exact (u, p) by forward-mode automatic
    differentiation:  f = du/dt + (u.grad)u + grad p - nu lap u.

    Returns ``f(points[..., dim], t) -> [..., dim]``.
    """
    comps = exact.components

    def u_point(x, t):
        pt = x[None, :]
        return torch.stack([comps[i].spatial(pt, t)[0] for i in range(dim)])

    def p_point(x, t):
        return comps[dim].spatial(x[None, :], t)[0]

    def f_point(x, t):
        dudt = jacfwd(u_point, argnums=1)(x, t)
        gradu = jacfwd(u_point, argnums=0)(x, t)           # [i, j]
        u = u_point(x, t)
        conv = gradu @ u
        gradp = jacfwd(p_point, argnums=0)(x, t)
        hess = jacfwd(jacfwd(u_point, argnums=0), argnums=0)(x, t)
        lap = torch.diagonal(hess, dim1=1, dim2=2).sum(-1)
        return dudt + conv + gradp - nu * lap

    def source(points, t=0.0):
        flat = points.reshape(-1, dim)
        t_arr = torch.as_tensor(t, dtype=points.dtype, device=points.device)
        out = vmap(lambda x: f_point(x, t_arr))(flat)
        return out.reshape(points.shape[:-1] + (dim,))

    return source
