"""Batch-minor (SoA) GLS element kernel in plain PyTorch.

Counterpart of ``softx_2020_200_tpu.ops.batched_kernel``, and the plain
version of the CUDA element kernel (``ops/gls_kernel.py``,
``csrc/gls_element.cu``): the same physics, in the layout the CUDA
kernel reads, with the element batch E as the trailing axis:

    ue[nn, c, E], xe[nn, d, E], uprev[nn, d, E], fq[q, d, E], h[E]
    -> r[nn, c, E]

(``[nn, c, E]`` contiguous is the ``[nn*c, E]`` row layout of the CUDA
kernel.)  The element size ``h`` is an input, computed once on the host
from the element volume (``element_size``), as the TPU kernel B1 takes
it (``softx_2020_200_tpu/ops/pallas_gls.py:359-390``).

Tangents are ``torch.func.jvp`` through this kernel; with
``stab.frozen_tau`` the stabilization parameter tau and the LSIC
coefficient are detached, which is the linearization B1 and the CUDA
kernel compute.  (The JAX package's XLA kernel detaches only tau, so
the two frozen tangents differ when LSIC is on.)
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:
    from ..solvers.gls import StabFlags


def _det_inv_soa(J):
    """J[q, d, d, E] -> (det[q, E], Jinv[q, d, d, E]) closed-form."""
    d = J.shape[1]
    if d == 2:
        a, b = J[:, 0, 0], J[:, 0, 1]
        c, e = J[:, 1, 0], J[:, 1, 1]
        det = a * e - b * c
        i = 1.0 / det
        inv = torch.stack([
            torch.stack([e * i, -b * i], dim=1),
            torch.stack([-c * i, a * i], dim=1)], dim=1)
        return det, inv
    m = J
    c00 = m[:, 1, 1] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 1]
    c01 = m[:, 1, 2] * m[:, 2, 0] - m[:, 1, 0] * m[:, 2, 2]
    c02 = m[:, 1, 0] * m[:, 2, 1] - m[:, 1, 1] * m[:, 2, 0]
    c10 = m[:, 0, 2] * m[:, 2, 1] - m[:, 0, 1] * m[:, 2, 2]
    c11 = m[:, 0, 0] * m[:, 2, 2] - m[:, 0, 2] * m[:, 2, 0]
    c12 = m[:, 0, 1] * m[:, 2, 0] - m[:, 0, 0] * m[:, 2, 1]
    c20 = m[:, 0, 1] * m[:, 1, 2] - m[:, 0, 2] * m[:, 1, 1]
    c21 = m[:, 0, 2] * m[:, 1, 0] - m[:, 0, 0] * m[:, 1, 2]
    c22 = m[:, 0, 0] * m[:, 1, 1] - m[:, 0, 1] * m[:, 1, 0]
    det = m[:, 0, 0] * c00 + m[:, 0, 1] * c01 + m[:, 0, 2] * c02
    i = 1.0 / det
    inv = torch.stack([
        torch.stack([c00 * i, c10 * i, c20 * i], dim=1),
        torch.stack([c01 * i, c11 * i, c21 * i], dim=1),
        torch.stack([c02 * i, c12 * i, c22 * i], dim=1)], dim=1)
    return det, inv


def element_size(basis, degree: int, xe: np.ndarray) -> np.ndarray:
    """h[E]: equivalent diameter of each element divided by the degree,
    from its volume under (degree+1)-point quadrature (host, float64)."""
    _, wts, _, G, _ = basis.quadrature(degree + 1)
    J = np.einsum("eni,qnj->eqij", np.asarray(xe, np.float64), G)
    vol = np.einsum("eq,q->e", np.linalg.det(J), wts)
    if xe.shape[-1] == 2:
        return np.sqrt(4.0 * vol / math.pi) / degree
    return np.cbrt(6.0 * vol / math.pi) / degree


def make_batched_kernel(*, dim: int, B, G, H, w, nu: float,
                        stab: StabFlags):
    """Returns r(ue, xe, uprev, fq, h, alpha0, sdt) in SoA layout.

    B[q, n], G[q, n, a], H[q, n, a, b], w[q] are tensors on the device
    and in the dtype of the element data.  Same physics as
    :func:`softx_2020_200_tpu.ops.batched_kernel.make_batched_kernel`,
    with ``h`` given instead of computed from the in-kernel volume.
    """
    d = dim

    def kernel(ue, xe, uprev, fq, h, alpha0, sdt):
        # geometry: J[q, i, j, E]
        J = torch.einsum("niE,qnj->qijE", xe, G)
        detJ, Jinv = _det_inv_soa(J)                 # [q,E], [q,i,j,E]
        scale = detJ * w[:, None]                    # [q, E]

        uq = torch.einsum("qn,ncE->qcE", B, ue)
        du_dxi = torch.einsum("qna,ncE->qcaE", G, ue)
        grad = torch.einsum("qcaE,qaiE->qciE", du_dxi, Jinv)
        vel = uq[:, :d]                              # [q, d, E]
        gvel = grad[:, :d]                           # [q, i, j, E]
        p = uq[:, d]                                 # [q, E]
        gp = grad[:, d]                              # [q, j, E]

        K = torch.einsum("qaiE,qbiE->qabE", Jinv, Jinv)
        # lap_phi[q, n, E] = H[q,n,a,b] K[q,a,b,E]; lap u = lap_phi . ue
        lap_phi = torch.einsum("qnab,qabE->qnE", H, K)
        lap = torch.einsum("qnE,ncE->qcE", lap_phi, ue[:, :d])

        # the time derivative from its nodal values (alpha0 u + combo,
        # a small difference of two large terms): float32 rounds the
        # small result, not alpha0 times the interpolated u
        udot = torch.einsum("qn,ndE->qdE", B, alpha0 * ue[:, :d] + uprev)
        conv = torch.einsum("qijE,qjE->qiE", gvel, vel)
        r_m = udot + conv + gp - nu * lap - fq
        div = torch.einsum("qiiE->qE", gvel)

        umag2 = torch.sum(vel * vel, dim=1)          # [q, E]
        h2 = h * h
        tau = 1.0 / torch.sqrt(sdt * sdt + 4.0 * umag2 / h2
                               + 9.0 * (4.0 * nu / h2) ** 2)
        if stab.frozen_tau:
            tau = tau.detach()

        a_v = scale[:, None] * (udot + conv - fq)            # [q, d, E]
        eye = torch.eye(d, dtype=ue.dtype, device=ue.device)
        a_g = scale[:, None, None] * (
            nu * gvel - p[:, None, None] * eye[None, :, :, None])
        a_p = scale * div
        a_pg = torch.zeros_like(gp)
        if stab.pspg:
            a_pg = a_pg + (scale * tau)[:, None] * r_m
        if stab.supg:
            a_g = a_g + (scale * tau)[:, None, None] * \
                torch.einsum("qiE,qjE->qijE", r_m, vel)
        if stab.lsic:
            tau_l = 0.5 * torch.sqrt(umag2) * h
            if stab.frozen_tau:
                # B1 freezes the LSIC coefficient with tau
                # (softx_2020_200_tpu/ops/pallas_gls.py:164-167)
                tau_l = tau_l.detach()
            a_g = a_g + (scale * tau_l * div)[:, None, None] * \
                eye[None, :, :, None]

        Rv = torch.einsum("qn,qiE->niE", B, a_v)
        ag_ref = torch.einsum("qijE,qajE->qiaE", a_g, Jinv)
        Rv = Rv + torch.einsum("qna,qiaE->niE", G, ag_ref)
        if stab.gls_viscous_adjoint:
            a_lap = -(scale * tau * nu)[:, None] * r_m       # [q, d, E]
            Rv = Rv + torch.einsum("qnE,qiE->niE", lap_phi, a_lap)
        Rp = torch.einsum("qn,qE->nE", B, a_p)
        apg_ref = torch.einsum("qjE,qajE->qaE", a_pg, Jinv)
        Rp = Rp + torch.einsum("qna,qaE->nE", G, apg_ref)
        return torch.cat([Rv, Rp[:, None]], dim=1)           # [n, c, E]

    return kernel


def tangent_batched(kernel, ue, due, xe, uprev, fq, h, alpha0, sdt):
    """d r / d ue along ``due`` (SoA), by forward-mode AD."""
    return torch.func.jvp(
        lambda v: kernel(v, xe, uprev, fq, h, alpha0, sdt),
        (ue,), (due,))[1]


def node_blocks_batched(kernel, ue, xe, uprev, fq, h, alpha0, sdt):
    """Node-diagonal Jacobian blocks [nn, c*c, E] (row-major (i, j)):

        blocks[n, i*c+j, e] = d r[n, i, e] / d ue[n, j, e]

    from nn*c forward-mode probes, each differentiating every element at
    once (the layout the CUDA probe kernel writes)."""
    nn, c, E = ue.shape
    out = ue.new_empty((nn, c * c, E))
    for k in range(nn * c):
        n0, j = divmod(k, c)
        probe = torch.zeros_like(ue)
        probe[n0, j] = 1.0
        col = tangent_batched(kernel, ue, probe, xe, uprev, fq, h,
                              alpha0, sdt)[n0]              # [c(i), E]
        out[n0, j::c] = col
    return out
