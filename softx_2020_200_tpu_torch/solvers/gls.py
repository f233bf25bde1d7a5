"""GLS-stabilized incompressible Navier-Stokes operator (counterpart of
``softx_2020_200_tpu.solvers.gls``).

Equal-order Qk-Qk velocity/pressure, Galerkin weak form plus SUPG + PSPG
(+ optional GLS viscous-adjoint and LSIC) stabilization with the
element-size-based tau, evaluated matrix-free:

    gather DoFs -> element kernel (ops/gls_kernel.py) -> gather-sum assembly

Strong momentum residual (per quad point):
    r_m = du/dt + (u.grad)u + grad p - nu lap u - f
Stabilization parameter (transient; steady drops the 1/dt term):
    tau = [ sdt^2 + (2|u|/h)^2 + 9 (4 nu / h^2)^2 ]^{-1/2}
with h the equivalent-diameter element size divided by the FE degree
(2D: sqrt(4 V / pi), 3D: cbrt(6 V / pi)), V from (degree+1)-point
quadrature, computed once on the host.

The Jacobian is never formed.  ``linearize(u, ...)`` captures the
element state once per Newton iteration and ``jvp(state, du)`` applies
J du: on CPU by forward-mode AD through the plain kernel (exact tau
unless frozen), on CUDA by the kernel's frozen-tau tangent.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..fem.dof import FESpace
from ..fem.geometry import det_and_inv
from ..ops.batched_kernel import element_size
from ..ops.gls_kernel import GLSElementKernel
from ..ops.operators import (assemble, build_assembly_map,
                             node_multiplicity)


@dataclass(frozen=True)
class StabFlags:
    supg: bool = True
    pspg: bool = True
    gls_viscous_adjoint: bool = True
    lsic: bool = False
    frozen_tau: bool = False


def make_element_kernel(*, dim: int, degree: int, B, G, H, w, nu: float,
                        stab: StabFlags):
    """Single-element GLS residual in the natural [nn, c] layout (the
    per-element form of ``ops/batched_kernel.py``; h from the volume of
    the element's own quadrature, as in the JAX package)."""
    d = dim
    eye = torch.eye(dim, dtype=B.dtype, device=B.device)

    def element_residual(ue, xe, uprev_e, fq, alpha0, sdt):
        J = torch.einsum("ni,qnj->qij", xe, G)
        detJ, Jinv = det_and_inv(J)
        scale = detJ * w

        uq = torch.einsum("qn,nc->qc", B, ue)
        du_dxi = torch.einsum("qna,nc->qca", G, ue)
        grad = torch.einsum("qca,qai->qci", du_dxi, Jinv)
        vel = uq[:, :d]
        gvel = grad[:, :d, :]
        p = uq[:, d]
        gp = grad[:, d, :]
        K = torch.einsum("qai,qbi->qab", Jinv, Jinv)
        d2u = torch.einsum("qnab,nc->qcab", H, ue[:, :d])
        lap = torch.einsum("qcab,qab->qc", d2u, K)

        udot = alpha0 * vel + torch.einsum("qn,nd->qd", B, uprev_e)
        conv = torch.einsum("qij,qj->qi", gvel, vel)
        r_m = udot + conv + gp - nu * lap - fq
        div = torch.einsum("qii->q", gvel)

        vol = torch.sum(scale)
        if d == 2:
            h = torch.sqrt(4.0 * vol / math.pi) / degree
        else:
            h = torch.pow(6.0 * vol / math.pi, 1.0 / 3.0) / degree
        umag2 = torch.sum(vel * vel, dim=-1)
        tau = 1.0 / torch.sqrt(
            sdt * sdt + 4.0 * umag2 / (h * h)
            + 9.0 * (4.0 * nu / (h * h)) ** 2)
        if stab.frozen_tau:
            tau = tau.detach()

        a_v = scale[:, None] * (udot + conv - fq)
        a_g = scale[:, None, None] * (nu * gvel - p[:, None, None] * eye)
        a_p = scale * div
        a_pg = torch.zeros_like(gp)
        if stab.pspg:
            a_pg = a_pg + (scale * tau)[:, None] * r_m
        if stab.supg:
            a_g = a_g + (scale * tau)[:, None, None] * \
                torch.einsum("qi,qj->qij", r_m, vel)
        if stab.lsic:
            tau_l = 0.5 * torch.sqrt(umag2) * h
            a_g = a_g + (scale * tau_l * div)[:, None, None] * eye

        Rv = torch.einsum("qn,qi->ni", B, a_v)
        ag_ref = torch.einsum("qij,qaj->qia", a_g, Jinv)
        Rv = Rv + torch.einsum("qna,qia->ni", G, ag_ref)
        if stab.gls_viscous_adjoint:
            a_lap = -(scale * tau * nu)[:, None] * r_m
            lap_phi = torch.einsum("qnab,qab->qn", H, K)
            Rv = Rv + torch.einsum("qn,qi->ni", lap_phi, a_lap)
        Rp = torch.einsum("qn,q->n", B, a_p)
        apg_ref = torch.einsum("qj,qaj->qa", a_pg, Jinv)
        Rp = Rp + torch.einsum("qna,qa->n", G, apg_ref)
        return torch.cat([Rv, Rp[:, None]], dim=-1)

    return element_residual


@dataclass
class Linearization:
    """Element state frozen at one Newton iterate (SoA rows)."""
    ue: torch.Tensor      # [nn, c, E]
    up: torch.Tensor      # [nn, d, E]
    fq: torch.Tensor      # [q, d, E]
    alpha0: float
    sdt: float


class GLSOperator(nn.Module):
    """Matrix-free GLS Navier-Stokes operator on one FESpace.

    Tables (B, G, H, w), geometry (xe, h, quadrature points), the
    connectivity and the assembly map are buffers: ``.to(device)`` moves
    all of them.
    """

    def __init__(self, space: FESpace, nu: float, n_q1d: int | None = None,
                 stab: StabFlags = StabFlags(), *,
                 dtype: torch.dtype = torch.float64,
                 device: torch.device | str = "cpu"):
        super().__init__()
        self.space = space
        self.dim = space.dim
        self.nc = self.dim + 1
        self.nu = float(nu)
        self.stab = stab
        self.degree = space.degree
        n_q1d = n_q1d or (space.degree + 1)
        _, wts, B, G, H = space.basis.quadrature(n_q1d)
        self.n_q = wts.shape[0]
        self.n_nodes = space.n_nodes
        self.nn = space.basis.n_nodes

        def buf(name, arr, dt=dtype):
            self.register_buffer(name, torch.as_tensor(
                np.array(arr), dtype=dt, device=device))

        xe = space.element_coords()                        # [E, nn, d]
        buf("B", B)                                        # [nq, nn]
        buf("G", G)                                        # [nq, nn, d]
        buf("H", H)                                        # [nq, nn, d, d]
        buf("w", wts)                                      # [nq]
        buf("elem_nodes", space.elem_nodes, torch.int64)   # [E, nn]
        buf("elem_nodes_t", space.elem_nodes.T, torch.int64)  # [nn, E]
        buf("xe", xe)                                      # [E, nn, d]
        buf("xe_soa", np.ascontiguousarray(np.transpose(xe, (1, 2, 0))))
        buf("h", element_size(space.basis, space.degree, xe))  # [E]
        mult = node_multiplicity(space.elem_nodes, space.n_nodes)
        buf("inv_mult", 1.0 / mult)
        self.amap = build_assembly_map(space.elem_nodes, space.n_nodes)
        buf("amap_idx", self.amap.idx, torch.int64)        # [N, M]
        # physical quad-point coordinates (source / error evaluation)
        buf("qpts_phys", np.einsum("qn,end->eqd", B, xe))  # [E, nq, d]

        self.kernel = GLSElementKernel(
            dim=self.dim, degree=self.degree, B=B, G=G, H=H, w=wts,
            nu=self.nu, stab=stab, dtype=dtype, device=device)

    @property
    def dtype(self) -> torch.dtype:
        return self.B.dtype

    @property
    def device(self) -> torch.device:
        return self.B.device

    # ------------------------------------------------------------------
    def _soa(self, u):
        """Nodal u[N, k] -> element rows [nn, k, E] (contiguous)."""
        return u[self.elem_nodes_t].transpose(1, 2).contiguous()

    def _assemble_rows(self, r):
        """Element rows r[nn, k, E] -> assembled [N, k]."""
        return assemble(r.permute(2, 0, 1), self.amap_idx)

    def _fq_soa(self, fq):
        return fq.permute(1, 2, 0).contiguous()             # [q, d, E]

    def residual_free(self, u, uprev_combo, fq, alpha0, sdt):
        """Unconstrained residual R(u): [N, d+1] -> [N, d+1]."""
        r = self.kernel.residual(self._soa(u), self.xe_soa,
                                 self._soa(uprev_combo), self._fq_soa(fq),
                                 self.h, alpha0, sdt)
        return self._assemble_rows(r)

    def residual(self, u, bc_mask, uprev_combo, fq, alpha0, sdt):
        """Constrained residual: zero at Dirichlet DoFs."""
        R = self.residual_free(u, uprev_combo, fq, alpha0, sdt)
        return torch.where(bc_mask, torch.zeros_like(R), R)

    def linearize(self, u, uprev_combo, fq, alpha0, sdt) -> Linearization:
        """Element state at ``u`` for repeated Jacobian-vector products."""
        return Linearization(ue=self._soa(u), up=self._soa(uprev_combo),
                             fq=self._fq_soa(fq), alpha0=float(alpha0),
                             sdt=float(sdt))

    def jvp(self, state: Linearization, du):
        """Unconstrained J(u) du: [N, d+1] -> [N, d+1]."""
        dr = self.kernel.tangent(state.ue, self._soa(du), self.xe_soa,
                                 state.up, state.fq, self.h, state.alpha0,
                                 state.sdt)
        return self._assemble_rows(dr)

    def node_blocks(self, u, bc_mask, uprev_combo, fq, alpha0, sdt):
        """Assembled per-node (d+1)x(d+1) Jacobian diagonal blocks
        [N, c, c] for (block-)Jacobi, with Dirichlet rows/cols zeroed."""
        c = self.nc
        blocks = self.kernel.node_blocks(
            self._soa(u), self.xe_soa, self._soa(uprev_combo),
            self._fq_soa(fq), self.h, alpha0, sdt)       # [nn, c*c, E]
        keep = 1.0 - self._soa(bc_mask.to(self.dtype))   # [nn, c, E]
        keep2 = keep[:, :, None, :] * keep[:, None, :, :]
        blocks = blocks * keep2.reshape(blocks.shape)
        return self._assemble_rows(blocks).reshape(self.n_nodes, c, c)

    # ------------------------------------------------------------------
    def cfl(self, u, dt):
        """max over elements/quad points of |u| dt / h, with h from the
        element's own quadrature volume (as the JAX package)."""
        d = self.dim
        J = torch.einsum("eni,qnj->eqij", self.xe, self.G)
        detJ, _ = det_and_inv(J)
        vol = torch.sum(detJ * self.w, dim=1)
        if d == 2:
            h = torch.sqrt(4.0 * vol / math.pi) / self.degree
        else:
            h = torch.pow(6.0 * vol / math.pi, 1.0 / 3.0) / self.degree
        ue = u[self.elem_nodes][..., :d]
        uq = torch.einsum("qn,end->eqd", self.B, ue)
        umax = torch.linalg.vector_norm(uq, dim=-1).amax(dim=1)
        return dt * torch.max(umax / h)
