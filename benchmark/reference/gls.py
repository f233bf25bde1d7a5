"""The GLS-stabilised Navier-Stokes residual of one BDF step, in plain
PyTorch float64: the equations that every solve of the benchmarked
decks has to satisfy.

Per element, at each Gauss point (Q_k-Q_k, d = 2 or 3):

    r_m = du/dt + (u.grad)u + grad p - nu lap u          (no source)
    tau = (sdt^2 + (2|u|/h)^2 + 9 (4 nu / h^2)^2)^(-1/2)

    R_v = (v, du/dt + (u.grad)u) + (grad v, nu grad u - p I)
          + SUPG (grad v . u, tau r_m) - viscous adjoint (lap v, tau nu r_m)
    R_p = (q, div u) + PSPG (grad q, tau r_m)

with du/dt = alpha0 u + sum_i alpha_i u^{n-i} from the step's BDF
weights, h the element's equivalent diameter over the degree (from its
(k+1)-point quadrature volume), and lap v the affine Laplacian of the
shape functions (the reference Hessians through J^-1 J^-T).  This is the
weak form as the solver's documentation states it; the element
integrals are summed into nodal rows with ``index_add_``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .fe import Element

# elements per block: a 3D Q1 block of this size holds a few hundred MB
# of float64 intermediates
BLOCK = 1 << 17


def bdf_weights(dts) -> np.ndarray:
    """BDF weights alpha[0..k] for the steps dts (newest first): du/dt at
    the new time ~ sum_i alpha[i] u^{n+1-i}, k = len(dts) in (1, 2)."""
    if len(dts) == 1:
        return np.array([1.0, -1.0]) / dts[0]
    h1, h2 = float(dts[0]), float(dts[1])
    return np.array([(2 * h1 + h2) / (h1 * (h1 + h2)),
                     -(h1 + h2) / (h1 * h2),
                     h1 / (h2 * (h1 + h2))])


class Residual:
    """R(u) of one BDF step on a mesh: element node coordinates xe[E, nn,
    d] (float64, unwrapped across periodic seams), connectivity
    elems[E, nn] into N nodes, viscosity nu and the GLS terms in
    ``stab`` (supg, pspg, gls_viscous_adjoint, lsic); float64 unless
    ``dtype`` says otherwise (the float32 reading of a diagnostic)."""

    def __init__(self, xe: np.ndarray, elems: np.ndarray, n_nodes: int,
                 degree: int, nu: float, stab: dict, device,
                 n_q1d: int | None = None, dtype=torch.float64):
        E, nn, d = xe.shape
        self.dim, self.n_nodes, self.nu, self.stab = d, n_nodes, nu, stab
        self.device = device
        el = Element(d, degree, n_q1d)
        kw = dict(dtype=dtype, device=device)
        self.B = torch.as_tensor(el.B, **kw)
        self.G = torch.as_tensor(el.G, **kw)
        self.H = torch.as_tensor(el.H, **kw)
        self.w = torch.as_tensor(el.w, **kw)
        self.xe = torch.as_tensor(xe, **kw)
        self.elems = torch.as_tensor(elems, dtype=torch.int64, device=device)
        # h from the volume under the (k+1)-point rule, over the degree
        vol_el = Element(d, degree, degree + 1)
        J = np.einsum("eni,qnj->eqij", xe, vol_el.G)
        vol = np.einsum("eq,q->e", np.linalg.det(J), vol_el.w)
        h = (np.sqrt(4.0 * vol / math.pi) if d == 2
             else np.cbrt(6.0 * vol / math.pi)) / degree
        self.h = torch.as_tensor(h, **kw)

    def __call__(self, u, combo, alpha0: float, sdt: float):
        """R[N, d+1] at u[N, d+1] with combo[N, d] = sum_i alpha_i
        u^{n+1-i} (velocity) and the step's alpha0 and 1/dt."""
        R = torch.zeros_like(u)
        for e0 in range(0, self.elems.shape[0], BLOCK):
            sl = slice(e0, e0 + BLOCK)
            idx = self.elems[sl]
            r = self._elements(u[idx], combo[idx], self.xe[sl], self.h[sl],
                               alpha0, sdt)
            R.index_add_(0, idx.reshape(-1), r.reshape(-1, r.shape[-1]))
        return R

    def _elements(self, ue, up, xe, h, alpha0, sdt):
        d, nu, st = self.dim, self.nu, self.stab
        B, G, H, w = self.B, self.G, self.H, self.w
        J = torch.einsum("eni,qnj->eqij", xe, G)
        detJ = torch.linalg.det(J)
        Jinv = torch.linalg.inv(J)                       # [e, q, a, i]
        scale = detJ * w                                 # [e, q]
        uq = torch.einsum("qn,enc->eqc", B, ue)
        du_dxi = torch.einsum("qna,enc->eqca", G, ue)
        grad = torch.einsum("eqca,eqai->eqci", du_dxi, Jinv)
        vel, p = uq[..., :d], uq[..., d]
        gvel, gp = grad[:, :, :d], grad[:, :, d]         # [e,q,i,j], [e,q,j]
        K = torch.einsum("eqai,eqbi->eqab", Jinv, Jinv)
        lap_phi = torch.einsum("qnab,eqab->eqn", H, K)
        lap = torch.einsum("eqn,eni->eqi", lap_phi, ue[..., :d])
        udot = torch.einsum("qn,eni->eqi", B, alpha0 * ue[..., :d] + up)
        conv = torch.einsum("eqij,eqj->eqi", gvel, vel)
        r_m = udot + conv + gp - nu * lap
        div = torch.einsum("eqii->eq", gvel)
        umag2 = (vel * vel).sum(-1)
        h2 = (h * h)[:, None]
        tau = 1.0 / torch.sqrt(sdt * sdt + 4.0 * umag2 / h2
                               + 9.0 * (4.0 * nu / h2) ** 2)
        eye = torch.eye(d, dtype=ue.dtype, device=ue.device)
        a_v = scale[..., None] * (udot + conv)
        a_g = scale[..., None, None] * (nu * gvel - p[..., None, None] * eye)
        a_pg = torch.zeros_like(gp)
        if st["pspg"]:
            a_pg = (scale * tau)[..., None] * r_m
        if st["supg"]:
            a_g = a_g + (scale * tau)[..., None, None] * \
                r_m[..., :, None] * vel[..., None, :]
        if st["lsic"]:
            tau_l = 0.5 * torch.sqrt(umag2) * h[:, None]
            a_g = a_g + (scale * tau_l * div)[..., None, None] * eye
        Rv = torch.einsum("qn,eqi->eni", B, a_v)
        ag_ref = torch.einsum("eqij,eqaj->eqia", a_g, Jinv)
        Rv = Rv + torch.einsum("qna,eqia->eni", G, ag_ref)
        if st["gls_viscous_adjoint"]:
            Rv = Rv - torch.einsum("eqn,eqi->eni", lap_phi,
                                   (scale * tau * nu)[..., None] * r_m)
        Rp = torch.einsum("qn,eq->en", B, scale * div)
        apg_ref = torch.einsum("eqj,eqaj->eqa", a_pg, Jinv)
        Rp = Rp + torch.einsum("qna,eqa->en", G, apg_ref)
        return torch.cat([Rv, Rp[..., None]], dim=-1)   # [e, nn, c]
