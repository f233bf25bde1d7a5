"""GLS-stabilized incompressible Navier-Stokes operator (counterpart of
``softx_2020_200_tpu.solvers.gls``).

Equal-order Qk-Qk velocity/pressure, Galerkin weak form plus SUPG + PSPG
(+ optional GLS viscous-adjoint and LSIC) stabilization with the
element-size-based tau, evaluated matrix-free:

    gather DoFs -> element kernel -> assembly

On a structured lattice whose elements are translates of one box (every
box deck) the gather and the assembly are strided window reads and adds
(ops/structured.py) around the lattice kernel B2 (ops/lattice_kernel.py);
on any other mesh they are index gathers and a gather-sum around the
element kernel B1 (ops/gls_kernel.py).  The operator picks its path once,
from the mesh, on every device.

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

With ``state_dtype=torch.bfloat16`` (the deck's ``jacobian state
precision = bf16``) the state that the tangent and the node-block probes
read is stored in bf16: ``linearize`` rounds ue, up and fq once per
Newton iteration, and B1's geometry (xe, h) is rounded once, here.  The
kernels widen every element on read, so the direction, the arithmetic
and the output stay in the compute dtype; the residual is untouched.
This is the JAX package's ``state_dtype`` of its Pallas kernels: an
inexact Newton with a rounded-coefficient Jacobian, frozen tau.

With ``dtype=torch.bfloat16`` every buffer is bf16, as in the JAX
package (``softx_2020_200_tpu/solvers/gls.py:168-177``), and so is every
row the operator hands its kernel: the gathers keep the dtype and lay the
rows out at one even pitch (``persistent_tiles.narrow_rows``), the kernel
runs its bf16-operand instance (bf16 rows, tables and output, float32
arithmetic inside; on the CPU its plain version), and the strided scatter
or the gather-sum assembly sums the bf16 outputs in bf16, in the same
order as in float32, as the JAX package sums in its dtype.  The tangent
freezes tau.  ``state_dtype=torch.bfloat16`` adds nothing to a bf16
operator.  On the card the kernels take float32 and bfloat16; another
dtype raises when the operator is built.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..fem.dof import FESpace
from ..fem.geometry import det_and_inv
from ..ops.batched_kernel import element_size, make_batched_kernel
from ..ops.gls_kernel import GLSElementKernel
from ..ops.lattice_kernel import LatticeGLSKernel, is_translate_lattice
from ..ops.operators import (assemble, build_assembly_map,
                             node_multiplicity)
from ..ops.persistent_tiles import narrow_rows
from ..ops.structured import StructuredLayout


@dataclass(frozen=True)
class StabFlags:
    supg: bool = True
    pspg: bool = True
    gls_viscous_adjoint: bool = True
    lsic: bool = False
    frozen_tau: bool = False


def make_element_kernel(*, dim: int, degree: int, B, G, H, w, nu: float,
                        stab: StabFlags):
    """Single-element GLS residual in the natural [nn, c] layout: the
    plain batched kernel (``ops/batched_kernel.py``) on a batch of one,
    with h from the volume of the element's own quadrature, as in the
    JAX package."""
    kernel = make_batched_kernel(dim=dim, B=B, G=G, H=H, w=w, nu=nu,
                                 stab=stab)

    def element_residual(ue, xe, uprev_e, fq, alpha0, sdt):
        J = torch.einsum("ni,qnj->qij", xe, G)
        vol = torch.sum(det_and_inv(J)[0] * w)
        if dim == 2:
            h = torch.sqrt(4.0 * vol / math.pi) / degree
        else:
            h = torch.pow(6.0 * vol / math.pi, 1.0 / 3.0) / degree
        return kernel(ue[..., None], xe[..., None], uprev_e[..., None],
                      fq[..., None], h[None], alpha0, sdt)[..., 0]

    return element_residual


@dataclass
class Linearization:
    """Element state frozen at one Newton iterate, in the rows of the
    operator's kernel: SoA ``[nn, c, E]``, ``[nn, d, E]``, ``[q, d, E]``
    for B1; component-major ``[c*nn, E]``, ``[d*nn, E]``, ``[d*q, E]``
    on the lattice path."""
    ue: torch.Tensor
    up: torch.Tensor
    fq: torch.Tensor
    alpha0: float
    sdt: float


def probe_columns(tangent, ue):
    """The columns of the element Jacobians, [n, n, E] (column, row,
    element) with n = ue.numel() // E in ``ue``'s own local order: column
    k is ``tangent(due)`` along the element-local one-hot direction
    ``due`` (local row k of every element at once), one probe live at a
    time.  Each column is stored whole and contiguous; a bf16 direction
    lies at the pitch of ``narrow_rows``, as the bf16 kernels take it."""
    E = ue.shape[-1]
    n = ue.numel() // E
    out = ue.new_empty((n, n, E))
    due = torch.zeros_like(ue)
    if due.dtype == torch.bfloat16:
        due = narrow_rows(due)
    flat = due.view(n, E)
    for k in range(n):
        flat[k] = 1.0
        out[k] = tangent(due).reshape(n, E)
        flat[k] = 0.0
    return out


class GLSOperator(nn.Module):
    """Matrix-free GLS Navier-Stokes operator on one FESpace.

    Tables (B, G, H, w), geometry (xe, h, quadrature points), the
    connectivity and the assembly map are buffers: ``.to(device)`` moves
    all of them.  ``state_dtype`` None keeps the Jacobian state in
    ``dtype``; ``torch.bfloat16`` stores it in bf16 (see the module's
    note), and B1's bf16 geometry rows are made here for the operator's
    device.  ``dtype=torch.bfloat16`` runs the kernels' bf16-operand
    instances (the module's note).
    """

    def __init__(self, space: FESpace, nu: float, n_q1d: int | None = None,
                 stab: StabFlags = StabFlags(), *,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda",
                 state_dtype: torch.dtype | None = None,
                 lattice: bool = True):
        super().__init__()
        if (torch.device(device).type == "cuda"
                and dtype not in (torch.float32, torch.bfloat16)):
            raise ValueError(f"GLS operator on the card: no kernel instance "
                             f"takes {dtype} (float32 or bfloat16)")
        if state_dtype not in (None, torch.bfloat16):
            raise ValueError(f"Jacobian state dtype {state_dtype}: None "
                             "(the compute dtype) or torch.bfloat16")
        self.state_dtype = state_dtype
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

        # the lattice path: a structured block of translates of one box
        self.layout = None
        if lattice and space.mesh.structured_shape is not None:
            layout = StructuredLayout(space)
            xe_grid = layout.elem_coords_grid_order()
            if is_translate_lattice(xe_grid, G):
                self.layout = layout
                buf("elem_perm", layout.elem_perm, torch.int64)
                self.kernel = LatticeGLSKernel(
                    dim=self.dim, degree=self.degree, B=B, G=G, H=H,
                    w=wts, xe0=xe_grid[0], nu=self.nu, stab=stab,
                    dtype=dtype, device=device)
        if self.layout is None:
            self.kernel = GLSElementKernel(
                dim=self.dim, degree=self.degree, B=B, G=G, H=H, w=wts,
                nu=self.nu, stab=stab, dtype=dtype, device=device)
            # the geometry B1's tangent and probes read: bf16 with a bf16
            # state (B1 rounds xe and h too), made once.  A bf16 operator's
            # residual reads the same rows, its coordinates relative to
            # each element's first node (rounded from float64): J is the
            # same, and bf16 rounds them to 2^-9 of an element's size,
            # where absolute bf16 coordinates move a fine curved mesh's
            # nodes by a large part of an element (ROADMAP C5, C7)
            xe_rows = self.xe_soa
            if dtype == torch.bfloat16:
                rel = xe - xe[:, :1]
                xe_rows = torch.as_tensor(np.ascontiguousarray(
                    np.transpose(rel, (1, 2, 0))), dtype=dtype,
                    device=device)
            self.xe_state = self._state(xe_rows)
            self.h_state = self._state(self.h)

    @property
    def dtype(self) -> torch.dtype:
        return self.B.dtype

    @property
    def device(self) -> torch.device:
        return self.B.device

    # ------------------------------------------------------------------
    def _state(self, rows):
        """Jacobian-state rows in the state dtype: rounded to bf16 (once,
        in rows ``state_rows`` lays out for the kernels) or as they are;
        a bf16 operator's rows, at that layout."""
        if self.state_dtype is None and self.dtype != torch.bfloat16:
            return rows
        return narrow_rows(rows)

    def _laid_out(self, rows):
        """Element rows as the kernel takes them: a bf16 operator's at the
        pitch of ``narrow_rows``, others as they are."""
        return narrow_rows(rows) if self.dtype == torch.bfloat16 else rows

    def _soa(self, u):
        """Nodal u[N, k] -> element rows [nn, k, E] (contiguous, or at
        the bf16 pitch)."""
        return self._laid_out(u[self.elem_nodes_t].transpose(1, 2)
                              .contiguous())

    def _assemble_rows(self, r):
        """Element rows r[nn, k, E] -> assembled [N, k]."""
        return assemble(r.permute(2, 0, 1), self.amap_idx)

    def _fq_soa(self, fq):
        return self._laid_out(fq.permute(1, 2, 0).contiguous())  # [q, d, E]

    def _rows(self, u):
        """Nodal u[N, k] -> lattice rows [k*nn, E] (element-lattice
        order)."""
        return self._laid_out(self.layout.gather(u).reshape(
            -1, self.layout.E))

    def _fq_rows(self, fq):
        """fq[E, q, d] in space element order -> lattice rows [d*q, E]."""
        return self._laid_out(fq[self.elem_perm].permute(2, 1, 0).reshape(
            -1, self.layout.E))

    def _scatter_rows(self, r):
        """Lattice rows [k*nn, E] -> assembled [N, k]."""
        return self.layout.scatter(r.reshape(-1, self.nn, self.layout.E))

    def residual_free(self, u, uprev_combo, fq, alpha0, sdt):
        """Unconstrained residual R(u): [N, d+1] -> [N, d+1]."""
        if self.layout is not None:
            r = self.kernel.residual(self._rows(u), self._rows(uprev_combo),
                                     self._fq_rows(fq), alpha0, sdt)
            return self._scatter_rows(r)
        xe, h = self._geometry()
        r = self.kernel.residual(self._soa(u), xe, self._soa(uprev_combo),
                                 self._fq_soa(fq), h, alpha0, sdt)
        return self._assemble_rows(r)

    def _geometry(self):
        """B1's full-precision geometry rows (xe, h): a bf16 operator's
        are its state rows."""
        if self.dtype == torch.bfloat16:
            return self.xe_state, self.h_state
        return self.xe_soa, self.h

    def residual(self, u, bc_mask, uprev_combo, fq, alpha0, sdt):
        """Constrained residual: zero at Dirichlet DoFs."""
        R = self.residual_free(u, uprev_combo, fq, alpha0, sdt)
        return torch.where(bc_mask, torch.zeros_like(R), R)

    def linearize(self, u, uprev_combo, fq, alpha0, sdt) -> Linearization:
        """Element state at ``u`` for repeated Jacobian-vector products,
        in the state dtype (rounded here, once per Newton iteration)."""
        if self.layout is not None:
            ue, up, fq = (self._rows(u), self._rows(uprev_combo),
                          self._fq_rows(fq))
        else:
            ue, up, fq = (self._soa(u), self._soa(uprev_combo),
                          self._fq_soa(fq))
        return Linearization(ue=self._state(ue), up=self._state(up),
                             fq=self._state(fq), alpha0=float(alpha0),
                             sdt=float(sdt))

    def jvp(self, state: Linearization, du):
        """Unconstrained J(u) du: [N, d+1] -> [N, d+1]."""
        if self.layout is not None:
            dr = self.kernel.tangent(state.ue, self._rows(du), state.up,
                                     state.fq, state.alpha0, state.sdt)
            return self._scatter_rows(dr)
        dr = self.kernel.tangent(state.ue, self._soa(du), self.xe_state,
                                 state.up, state.fq, self.h_state,
                                 state.alpha0, state.sdt)
        return self._assemble_rows(dr)

    def node_blocks(self, u, bc_mask, uprev_combo, fq, alpha0, sdt):
        """Assembled per-node (d+1)x(d+1) Jacobian diagonal blocks
        [N, c, c] for (block-)Jacobi, with Dirichlet rows/cols zeroed;
        the state in the state dtype, as the tangent reads it."""
        c = self.nc
        keep_mask = 1.0 - bc_mask.to(self.dtype)
        if self.layout is not None:
            blocks = self.kernel.node_blocks(
                self._state(self._rows(u)),
                self._state(self._rows(uprev_combo)),
                self._state(self._fq_rows(fq)), alpha0, sdt)  # [nn, c*c, E]
            keep = self.layout.gather(keep_mask)          # [c, nn, E]
            keep2 = (keep[:, None] * keep[None, :]).permute(2, 0, 1, 3)
            blocks = blocks * keep2.reshape(blocks.shape)
            return self.layout.scatter(blocks.transpose(0, 1)).reshape(
                self.n_nodes, c, c)
        blocks = self.kernel.node_blocks(
            self._state(self._soa(u)), self.xe_state,
            self._state(self._soa(uprev_combo)),
            self._state(self._fq_soa(fq)), self.h_state, alpha0,
            sdt)                                         # [nn, c*c, E]
        keep = self._soa(keep_mask)                      # [nn, c, E]
        keep2 = keep[:, :, None, :] * keep[:, None, :, :]
        blocks = blocks * keep2.reshape(blocks.shape)
        return self._assemble_rows(blocks).reshape(self.n_nodes, c, c)

    def element_matrices(self, u, bc_mask, uprev_combo, fq, alpha0, sdt):
        """Per-element dense Jacobian matrices [E, nn*c, nn*c] in the
        space's element order (row and column n*c + i, the order of
        ``u[elem_nodes]``), for additive Schwarz.  Constrained rows and
        columns are zeroed with a unit diagonal.  From nn*c tangent
        probes of the operator's kernel, one live at a time: on CPU
        forward-mode AD through the plain kernel (exact tau unless
        frozen, the JAX package's ``element_matrices``); on CUDA the
        kernel's frozen-tau tangent, the operator the Krylov matvec
        applies there.  The state is the full-precision one whatever
        ``state_dtype`` says, as in the JAX package."""
        nn, c = self.nn, self.nc
        if self.layout is not None:
            ue = self._rows(u)
            args = (self._rows(uprev_combo), self._fq_rows(fq))
        else:
            ue = self._soa(u)
            xe, h = self._geometry()
            args = (xe, self._soa(uprev_combo), self._fq_soa(fq), h)
        cols = probe_columns(
            lambda due: self.kernel.tangent(ue, due, *args, alpha0, sdt), ue)
        E = cols.shape[-1]
        if self.layout is not None:
            # component-major local order (k*nn + n) -> node-major, lattice
            # element order -> the space's (elem_perm maps grid -> space)
            A = cols.new_empty((E, nn * c, nn * c))
            A.view(E, nn, c, nn, c)[self.elem_perm] = cols.view(
                c, nn, c, nn, E).permute(4, 3, 2, 1, 0)
            del cols
        else:
            A = cols.permute(2, 1, 0)                    # a view, no copy
        m = bc_mask[self.elem_nodes].reshape(E, nn * c).to(A.dtype)
        keep = 1.0 - m
        A.mul_(keep[:, :, None]).mul_(keep[:, None, :])
        A.diagonal(dim1=1, dim2=2).add_(m)
        return A

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
