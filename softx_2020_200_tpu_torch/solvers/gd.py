"""Grad-div stabilized Taylor-Hood solver (counterpart of
``softx_2020_200_tpu.solvers.gd``).

Inf-sup stable Q(k+1)-Qk velocity/pressure pair, Galerkin weak form plus
grad-div stabilization gamma (div u, div v), Newton + matrix-free Krylov
with the block-triangular Schur preconditioner: the velocity block is
node-block Jacobi or a geometric V-cycle (``ops/gd_multigrid.py``), the
Schur complement the grad-div approximation S^-1 ~ -(nu + gamma) Mp^-1
with a lumped pressure mass.

State layout: one flat vector [Nv*d + Np] (velocity node-major, then
pressure), as in the JAX package.

The operator picks its path once, from the mesh.  On a structured
lattice whose elements are translates of one box, the gathers and
scatters of both spaces are strided window reads and adds
(``ops/structured.py``) around the lattice kernel B3
(``ops/lattice_gd_kernel.py``); on any other mesh they are index gathers
and a gather-sum around the SoA weak form in plain PyTorch, which is
what the JAX package runs there too (XLA, not Pallas).  The GD weak form
has no stabilization parameter, so the Jacobian action is exact on both
paths: ``linearize`` captures the element state once per Newton
iteration and ``jvp`` applies J dx.

With ``dtype=torch.bfloat16`` every buffer is bf16, as in the JAX
package; on the lattice path the gathers keep the dtype and lay the rows
out at one even pitch (``persistent_tiles.narrow_rows``), B3 runs its
bf16-operand instances (bf16 rows, tables and output, float32 arithmetic
inside; on the CPU its plain version), and the strided scatter sums the
bf16 outputs in bf16.

Time stepping is BDF1-3 or SDIRK2/3 (the stages through the velocity
history only); a checkpoint is the JAX package's ``.npz`` (u, previous,
control, pvd, n_dofs, and on a forest its leaves and base mesh), read by
either package.  As in the JAX GD engine, ``solver = pseudo_transient``
is ignored: a steady solve is Newton.

``mesh adaptation type = kelly`` puts the mesh in a forest, as in the
GLS engine (``solvers/base.py``): both spaces carry hanging-node
constraints, the velocity-block GMG coarsens through the forest, and
Kelly on the velocity (an equal-order view of the velocity space)
adapts between steady cycles or after every ``frequency``-th step,
carrying the mixed state and its history across.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time as _time
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch
from torch import nn

from ..core.bdf import bdf_coefficients
from ..core.expressions import VectorExpression
from ..core.parameters import BoundaryType, SimulationParameters, Verbosity
from ..core.pvd_handler import PVDHandler
from ..core.sdirk import sdirk_coefficients
from ..core.simulation_control import SimulationControl
from ..core.timer import SectionTimer
from ..fem.constraints import build_hanging_constraints
from ..fem.dof import FESpace
from ..fem.geometry import det_and_inv
from ..fem.mesh import Mesh
from ..fem.transfer import transfer_solution
from ..ops.batched_kernel import _det_inv_soa
from ..ops.gd_multigrid import (GDVelocityLevel, build_gd_hierarchy,
                                make_gd_vcycle)
from ..ops.lattice_gd_kernel import LatticeGDKernel
from ..ops.lattice_kernel import is_translate_lattice
from ..ops.operators import assemble, build_assembly_map
from ..ops.persistent_tiles import narrow_rows
from ..ops.preconditioners import _invert_blocks
from ..ops.structured import StructuredLayout
from ..utils.tables import Table
from ..utils.vtu import subcell_connectivity, write_vtu
from . import postprocessing as post
from .base import (adapt_forest, add_periodic_pairs, checkpoint_path,
                   forest_checkpoint, load_checkpoint, new_forest,
                   new_stats, read_base_mesh, record_solve, restore_forest,
                   snapshot_forest, write_npz_atomic)
from .boundary import BoundaryHandler
from .kelly import kelly_estimate
from .newton import NewtonConfig, newton_solve


def gd_soa_residual(ve_t, pe_t, vpe_t, xe_t, fq_t, Bv, Gv, Bp, w, nu, gamma,
                    alpha0):
    """Element-local grad-div Taylor-Hood weak form, SoA batch-minor.

    ve_t[nnv, d, E], pe_t[nnp, E], vpe_t[nnv, d, E], xe_t[nnv, d, E],
    fq_t[q, d, E] -> (Rv[nnv, d, E], Rp[nnp, E])."""
    d = ve_t.shape[1]
    J = torch.einsum("niE,qnj->qijE", xe_t, Gv)
    detJ, Jinv = _det_inv_soa(J)
    scale = detJ * w[:, None]

    vq = torch.einsum("qn,ndE->qdE", Bv, ve_t)
    dv_dxi = torch.einsum("qna,ndE->qdaE", Gv, ve_t)
    gv = torch.einsum("qdaE,qaiE->qdiE", dv_dxi, Jinv)
    pq = torch.einsum("qn,nE->qE", Bp, pe_t)
    vdot = alpha0 * vq + torch.einsum("qn,ndE->qdE", Bv, vpe_t)
    conv = torch.einsum("qijE,qjE->qiE", gv, vq)
    div = torch.einsum("qiiE->qE", gv)

    # momentum test-function coefficients
    a_v = scale[:, None] * (vdot + conv - fq_t)
    eye = torch.eye(d, dtype=ve_t.dtype, device=ve_t.device)
    a_g = scale[:, None, None] * (
        nu * gv + (gamma * div - pq)[:, None, None] * eye[None, :, :, None])
    # continuity
    a_p = scale * div

    Rv = torch.einsum("qn,qiE->niE", Bv, a_v)
    ag_ref = torch.einsum("qijE,qajE->qiaE", a_g, Jinv)
    Rv = Rv + torch.einsum("qna,qiaE->niE", Gv, ag_ref)
    Rp = torch.einsum("qn,qE->nE", Bp, a_p)
    return Rv, Rp


@dataclass
class GDLinearization:
    """Element state frozen at one Newton iterate: lattice rows
    ``ue [d*nnv + nnp, E]`` on the lattice path; SoA ``ve [nnv, d, E]``,
    ``pe [nnp, E]``, ``vpe``, ``fq [q, d, E]`` on the other."""
    alpha0: float
    ue: torch.Tensor | None = None
    ve: torch.Tensor | None = None
    pe: torch.Tensor | None = None
    vpe: torch.Tensor | None = None
    fq: torch.Tensor | None = None


class GDOperator(nn.Module):
    """Matrix-free grad-div Taylor-Hood operator on a mesh: Q(k+1)
    velocity and Qk pressure (k = ``degree_pressure``) on the same
    quadrature (k + 2 Gauss points per axis by default)."""

    def __init__(self, mesh: Mesh, degree_pressure: int = 1,
                 nu: float = 1.0, gamma: float = 1.0,
                 n_q1d: int | None = None, *,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.mesh = mesh
        self.dim = d = mesh.dim
        self.nu = float(nu)
        self.gamma = float(gamma)
        self.degree_pressure = degree_pressure
        self.space_v = FESpace(mesh, degree_pressure + 1)
        self.space_p = FESpace(mesh, degree_pressure)
        n_q1d = n_q1d or (degree_pressure + 2)
        _, wts, Bv, Gv, _ = self.space_v.basis.quadrature(n_q1d)
        _, _, Bp, _, _ = self.space_p.basis.quadrature(n_q1d)
        self.n_q = wts.shape[0]
        self.Nv = self.space_v.n_nodes
        self.Np = self.space_p.n_nodes
        self.nn_v = self.space_v.basis.n_nodes
        self.nn_p = self.space_p.basis.n_nodes
        self.n_dofs = self.Nv * d + self.Np

        def buf(name, arr, dt=dtype):
            self.register_buffer(name, torch.as_tensor(
                np.array(arr), dtype=dt, device=device))

        xe = self.space_v.element_coords()                  # [E, nnv, d]
        buf("Bv", Bv)                                       # [q, nnv]
        buf("Gv", Gv)                                       # [q, nnv, d]
        buf("Bp", Bp)                                       # [q, nnp]
        buf("w", wts)                                       # [q]
        buf("conn_v", self.space_v.elem_nodes, torch.int64)  # [E, nnv]
        buf("conn_p", self.space_p.elem_nodes, torch.int64)  # [E, nnp]
        buf("conn_v_t", self.space_v.elem_nodes.T, torch.int64)
        buf("conn_p_t", self.space_p.elem_nodes.T, torch.int64)
        buf("xe", xe)
        buf("xe_soa", np.ascontiguousarray(np.transpose(xe, (1, 2, 0))))
        buf("amap_v", build_assembly_map(self.space_v.elem_nodes,
                                         self.Nv).idx, torch.int64)
        buf("amap_p", build_assembly_map(self.space_p.elem_nodes,
                                         self.Np).idx, torch.int64)
        buf("qpts_phys", np.einsum("qn,end->eqd", Bv, xe))  # [E, q, d]
        self._vlevel = None

        # the lattice path: a structured block of translates of one box
        self.layout_v = self.layout_p = None
        if mesh.structured_shape is not None:
            lv = StructuredLayout(self.space_v)
            xe_grid = lv.elem_coords_grid_order()
            if is_translate_lattice(xe_grid, Gv):
                lp = StructuredLayout(self.space_p)
                if not np.array_equal(lv.elem_perm, lp.elem_perm):
                    raise ValueError("the velocity and pressure lattices "
                                     "order their elements differently")
                self.layout_v, self.layout_p = lv, lp
                buf("elem_perm", lv.elem_perm, torch.int64)
                self.kernel = LatticeGDKernel(
                    dim=d, degree_pressure=degree_pressure, Bv=Bv, Gv=Gv,
                    Bp=Bp, w=wts, xe0=xe_grid[0], nu=self.nu,
                    gamma=self.gamma, dtype=dtype, device=device)

    @property
    def dtype(self) -> torch.dtype:
        return self.Bv.dtype

    @property
    def device(self) -> torch.device:
        return self.Bv.device

    # ------------------------------------------------------------------
    def split(self, x):
        v = x[:self.Nv * self.dim].reshape(self.Nv, self.dim)
        return v, x[self.Nv * self.dim:]

    def join(self, v, p):
        return torch.cat([v.reshape(-1), p])

    # lattice rows (element-lattice order) ------------------------------
    def _laid_out(self, rows):
        """Rows as B3 takes them: a bf16 operator's at the pitch of
        ``narrow_rows``, others as they are."""
        return narrow_rows(rows) if self.dtype == torch.bfloat16 else rows

    def _vrows(self, v):
        """Nodal v[Nv, d] -> rows [d*nnv, E] (component-major)."""
        return self._laid_out(self.layout_v.gather(v).reshape(
            -1, self.layout_v.E))

    def _rows(self, x):
        """Flat x -> mixed rows [d*nnv + nnp, E]: velocity component i at
        rows i*nnv + n, then the pressure."""
        v, p = self.split(x)
        return self._laid_out(torch.cat([
            self.layout_v.gather(v).reshape(-1, self.layout_v.E),
            self.layout_p.gather(p[:, None]).reshape(-1, self.layout_p.E)]))

    def _fq_rows(self, fq):
        """fq[E, q, d] in space element order -> rows [d*q, E]."""
        return self._laid_out(fq[self.elem_perm].permute(2, 1, 0).reshape(
            -1, self.layout_v.E))

    def _scatter_rows(self, r):
        """Mixed rows [d*nnv + nnp, E] -> assembled flat [Nv*d + Np]."""
        E, nv = self.layout_v.E, self.dim * self.nn_v
        Rv = self.layout_v.scatter(r[:nv].reshape(self.dim, self.nn_v, E))
        Rp = self.layout_p.scatter(r[nv:].reshape(1, self.nn_p, E))
        return self.join(Rv, Rp[:, 0])

    # SoA element blocks (space element order) --------------------------
    def _soa(self, x):
        """Flat x -> (ve [nnv, d, E], pe [nnp, E])."""
        v, p = self.split(x)
        return v[self.conn_v_t].transpose(1, 2), p[self.conn_p_t]

    def _assemble(self, Rv, Rp):
        """(Rv [nnv, d, E], Rp [nnp, E]) -> assembled flat."""
        return self.join(assemble(Rv.permute(2, 0, 1), self.amap_v),
                         assemble(Rp.T[:, :, None], self.amap_p)[:, 0])

    def _soa_residual(self, ve, pe, vpe, fq, alpha0):
        return gd_soa_residual(ve, pe, vpe, self.xe_soa, fq, self.Bv,
                               self.Gv, self.Bp, self.w, self.nu,
                               self.gamma, alpha0)

    # ------------------------------------------------------------------
    def residual_free(self, x, vprev_combo, fq, alpha0):
        """Mixed residual: flat x [Nv*d + Np] -> same shape.

        vprev_combo [Nv, d]: sum_i alpha_i u^{n-i} at velocity nodes;
        fq [E, q, d]: the body force at the quadrature points."""
        if self.layout_v is not None:
            r = self.kernel.residual(self._rows(x), self._vrows(vprev_combo),
                                     self._fq_rows(fq), alpha0)
            return self._scatter_rows(r)
        ve, pe = self._soa(x)
        vpe = vprev_combo[self.conn_v_t].transpose(1, 2)
        Rv, Rp = self._soa_residual(ve, pe, vpe, fq.permute(1, 2, 0), alpha0)
        return self._assemble(Rv, Rp)

    def linearize(self, x, vprev_combo, fq, alpha0):
        """Element state at ``x`` for repeated Jacobian-vector products."""
        if self.layout_v is not None:
            return GDLinearization(alpha0=float(alpha0), ue=self._rows(x))
        ve, pe = self._soa(x)
        return GDLinearization(
            alpha0=float(alpha0), ve=ve, pe=pe,
            vpe=vprev_combo[self.conn_v_t].transpose(1, 2),
            fq=fq.permute(1, 2, 0))

    def jvp(self, state: GDLinearization, dx):
        """Unconstrained J(x) dx: flat -> flat (exact)."""
        if self.layout_v is not None:
            dr = self.kernel.tangent(state.ue, self._rows(dx), state.alpha0)
            return self._scatter_rows(dr)
        dve, dpe = self._soa(dx)
        _, (dRv, dRp) = torch.func.jvp(
            lambda ve, pe: self._soa_residual(ve, pe, state.vpe, state.fq,
                                              state.alpha0),
            (state.ve, state.pe), (dve, dpe))
        return self._assemble(dRv, dRp)

    # ------------------------------------------------------------------
    def velocity_level(self) -> GDVelocityLevel:
        """The velocity-block operator on this operator's velocity space
        (geometry in SoA layout, built once)."""
        if self._vlevel is None:
            self._vlevel = GDVelocityLevel(
                self.space_v, self.nu, self.gamma,
                int(round(self.n_q ** (1.0 / self.dim))), dtype=self.dtype,
                device=self.device)
        return self._vlevel

    def velocity_node_blocks(self, x, alpha0):
        """[Nv, d, d] assembled velocity-block diagonal (row: equation
        component, column: unknown component), in closed form.  The JAX
        package probes the same blocks with nnv*d jvps; neither the BDF
        history nor the body force enters them."""
        lv = self.velocity_level()
        v, _ = self.split(x)
        uq, guq = lv.lin_state(v)
        return lv.node_blocks(uq, guq, alpha0)

    def _wdet(self):
        """(det J * w [E, q], J^-1 [E, q, d, d]) on the velocity
        geometry."""
        J = torch.einsum("eni,qnj->eqij", self.xe, self.Gv)
        detJ, Jinv = det_and_inv(J)
        return detJ * self.w[None, :], Jinv

    def l2_errors(self, x, exact, t=0.0):
        """(err_v, err_p) against a VectorExpression (pressure
        mean-shifted)."""
        d = self.dim
        v, p = self.split(x)
        vq = torch.einsum("qn,end->eqd", self.Bv, v[self.conn_v])
        pq = torch.einsum("qn,en->eq", self.Bp, p[self.conn_p])
        wdet, _ = self._wdet()
        ex = exact.spatial(self.qpts_phys, t)
        vol = torch.sum(wdet)
        dv = vq - ex[..., :d]
        err_v = torch.sqrt(torch.sum(wdet[..., None] * dv * dv))
        dp = pq - ex[..., d]
        dp = dp - torch.sum(wdet * dp) / vol
        err_p = torch.sqrt(torch.sum(wdet * dp * dp))
        return err_v, err_p

    def cfl(self, x, dt):
        """max over elements/quad points of |u| dt / h (h from the
        element's volume and the velocity degree)."""
        wdet, _ = self._wdet()
        vol = torch.sum(wdet, dim=1)
        k = self.space_v.degree
        if self.dim == 2:
            h = torch.sqrt(4.0 * vol / math.pi) / k
        else:
            h = torch.pow(6.0 * vol / math.pi, 1.0 / 3.0) / k
        v, _ = self.split(x)
        vq = torch.einsum("qn,end->eqd", self.Bv, v[self.conn_v])
        umax = torch.linalg.vector_norm(vq, dim=-1).amax(dim=1)
        return torch.max(umax / h) * dt

    def pressure_lumped_mass(self):
        """Lumped pressure mass diag [Np] (for the Schur approximation)."""
        J = torch.einsum("niE,qnj->qijE", self.xe_soa, self.Gv)
        detJ, _ = _det_inv_soa(J)
        lumped = torch.einsum("qn,qE->nE", self.Bp, detJ * self.w[:, None])
        return assemble(lumped.T[:, :, None], self.amap_p)[:, 0]


class GDNavierStokesSolver:
    """Taylor-Hood grad-div solver engine (GDNavierStokesSolver<dim>).

    Shares the deck schema with the GLS engine; gamma comes from
    'stabilization / set gamma' (default 1.0).  Steady and transient BDF
    paths; Newton + (F)GMRES with the block-triangular Schur
    preconditioner.  Everything runs on one device given at
    construction (CUDA and float32 by default, as the CLI).  The JAX GD
    engine has no multigrid stagnation fallback, and neither has this
    one: a weak cycle shows as a solve that ends above its tolerance
    (``stats["solves_above_tolerance"]``).
    """

    def __init__(self, prm: SimulationParameters, mesh: Mesh | None = None,
                 *, device: torch.device | str = "cuda",
                 dtype: torch.dtype = torch.float32):
        self.prm = prm
        self.dim = prm.dim
        self.device = torch.device(device)
        self.dtype = dtype
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the solver runs on CUDA unless device='cpu' "
                               "is given, and CUDA is not available")
        if self.device.type == "cuda":
            # f32 means f32: no TF32 in any matrix product
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.control = SimulationControl(prm.simulation_control)
        self.pvd = PVDHandler()
        self.timer = SectionTimer()
        self._force_tables: dict[int, Table] = {}
        self._torque_tables: dict[int, Table] = {}
        self.tables: dict[str, list] = {"ke": [], "enstrophy": []}
        self.stats = new_stats()
        self._sharded_hook = None
        self.forest = None
        self._elem_of = None
        self._nc_faces = []
        if mesh is None:
            if prm.mesh_adaptation.type == "kelly":
                # the forest owns refinement (as in the GLS engine; the GD
                # engine's deck manifolds are not applied, as in the JAX
                # package)
                base = read_base_mesh(prm, self.dim, 0)
                add_periodic_pairs(prm, base)
                self.forest, mesh, self._elem_of, self._nc_faces = \
                    new_forest(base, prm.mesh.initial_refinement)
            else:
                mesh = read_base_mesh(prm, self.dim,
                                      prm.mesh.initial_refinement)
        # periodic declarations reach the mesh before the two FE spaces
        # are numbered
        add_periodic_pairs(prm, mesh)
        self._mesh = mesh
        self.exact = (VectorExpression(prm.analytical_solution.uvwp)
                      if prm.analytical_solution.enable else None)
        self.source = (VectorExpression(prm.source_term.xyz)
                       if prm.source_term.enable else None)
        self._mms = None
        if self.source is not None and \
                prm.source_term.xyz.strip().lower().startswith("mms"):
            from .analytical import mms_source
            self._mms = mms_source(
                self.exact, prm.physical_properties.kinematic_viscosity,
                self.dim)

        ls, nls = prm.linear_solver, prm.nonlinear_solver
        self.newton_cfg = NewtonConfig(
            tolerance=nls.tolerance, max_iterations=nls.max_iterations,
            max_halvings=nls.max_line_search_halvings,
            gmres_restart=ls.max_krylov_vectors,
            max_krylov_cycles=max(1, ls.max_iters // ls.max_krylov_vectors),
            relative_residual=ls.relative_residual,
            minimum_residual=ls.minimum_residual)
        self.setup()

    # ------------------------------------------------------------------
    def setup(self, mesh: Mesh | None = None, nc_faces=None) -> None:
        """(Re)build spaces, operator, boundary mask, hanging-node
        constraints (on both spaces) and preconditioner on the current or
        a given mesh (an adapted forest's, with its non-conforming
        faces)."""
        prm = self.prm
        if mesh is not None:
            self._mesh = mesh
        if nc_faces is not None:
            self._nc_faces = nc_faces
        kw = dict(dtype=self.dtype, device=self.device)
        self.op = op = GDOperator(
            self._mesh, degree_pressure=prm.fem.pressure_order,
            nu=prm.physical_properties.kinematic_viscosity,
            gamma=prm.stabilization.gamma, **kw)
        self.bh = BoundaryHandler(op.space_v, prm.boundary_conditions, **kw)
        self.hc_v = build_hanging_constraints(
            op.space_v, self._nc_faces).to(self.device, self.dtype)
        self.hc_p = build_hanging_constraints(
            op.space_p, self._nc_faces).to(self.device, self.dtype)
        d = self.dim
        # flat Dirichlet mask over [Nv*d + Np]; hanging rows act like
        # extra Dirichlet rows for masking and preconditioning
        mask_v = self.bh.mask[:, :d].clone()
        mask_v[self.hc_v.ids] = True
        mask_p = torch.zeros(op.Np, dtype=torch.bool, device=self.device)
        mask_p[self.hc_p.ids] = True
        self._mask = torch.cat([mask_v.reshape(-1), mask_p])
        self._mp = op.pressure_lumped_mass()
        self._zero_prev = torch.zeros((op.Nv, d), **kw)
        # velocity-block GMG: the GD analogue of the reference
        # BlockSchurPreconditioner's ILU/AMG velocity solve
        ls = prm.linear_solver
        self.precond_kind = ls.resolved_preconditioner()
        self.mg_levels = []
        self._mg_builder = None
        if self.precond_kind == "gmg":
            levels = build_gd_hierarchy(self)
            if len(levels) >= 2:
                self.mg_levels = levels
                self._mg_builder = make_gd_vcycle(levels)
                self.newton_cfg = dataclasses.replace(self.newton_cfg,
                                                      flexible=True)
            else:
                self.precond_kind = "block_jacobi"
        if ls.preconditioner == "auto" and not prm.test.enable:
            what = (f"gmg ({len(self.mg_levels)} levels)"
                    if self._mg_builder is not None else
                    "block_jacobi (no multigrid hierarchy on this mesh)")
            print(f"linear solver: preconditioner 'auto' resolves to {what}")

    # ------------------------------------------------------------------
    def _hc_distribute(self, x):
        if self.hc_v.n == 0 and self.hc_p.n == 0:
            return x
        v, p = self.op.split(x)
        return self.op.join(self.hc_v.distribute(v),
                            self.hc_p.distribute(p[:, None])[:, 0])

    def _hc_transpose(self, R):
        if self.hc_v.n == 0 and self.hc_p.n == 0:
            return R
        v, p = self.op.split(R)
        return self.op.join(self.hc_v.distribute_transpose(v),
                            self.hc_p.distribute_transpose(p[:, None])[:, 0])

    def _bc_values_flat(self, t):
        vals = self.bh.values(t)[:, :self.dim]
        return torch.cat([vals.reshape(-1), vals.new_zeros(self.op.Np)])

    def _source_q(self, t):
        qpts = self.op.qpts_phys
        if self._mms is not None:
            return self._mms(qpts, t)
        if self.source is None:
            return torch.zeros_like(qpts)
        return self.source.spatial(qpts, t)[..., :self.dim]

    def _precond_builder(self, alpha0):
        """x -> (r -> M^-1 r): the block-triangular Schur preconditioner,
        rebuilt at each Newton iterate.  The pressure comes first, by the
        grad-div Schur approximation zp = -(nu + gamma) rp / Mp; then the
        velocity block: with GMG one V-cycle on rv - B^T zp, else
        node-block Jacobi on rv."""
        op, d = self.op, self.dim
        mask_v = self._mask[:op.Nv * d].reshape(op.Nv, d)
        schur_scale = -(op.nu + op.gamma)
        eye = torch.eye(d, dtype=self.dtype, device=self.device)

        def gmg(x):
            v_lin, _ = op.split(self._hc_distribute(x))
            vcycle = self._mg_builder(v_lin, alpha0)
            lv0 = self.mg_levels[0].op

            def apply(r):
                rv, rp = op.split(r)
                zp = schur_scale * rp / self._mp
                # B^T zp: the momentum rows of -(zp, div w)
                zq = op.Bp @ zp[op.conn_p_t]                    # [q, E]
                g = torch.einsum("qE,qniE->niE", -lv0.scale * zq, lv0.gB)
                Bt = assemble(g.permute(2, 0, 1), op.amap_v)
                zero = torch.zeros_like(rv)
                rv2 = torch.where(mask_v, zero, rv - Bt)
                zv = torch.where(mask_v, rv, vcycle(rv2))
                return op.join(zv, zp)

            return apply

        def block_jacobi(x):
            blocks = op.velocity_node_blocks(x, alpha0)
            mrow = mask_v.to(blocks.dtype)
            keep = 1.0 - mrow
            blocks = (blocks * keep[:, :, None] * keep[:, None, :]
                      + mrow[:, :, None] * eye)
            binv = _invert_blocks(blocks, eye)

            def apply(r):
                rv, rp = op.split(r)
                zv = torch.einsum("nij,nj->ni", binv, rv)
                return op.join(zv, schur_scale * rp / self._mp)

            return apply

        return gmg if self._mg_builder is not None else block_jacobi

    def _newton(self, x0, combo, t, alpha0):
        """One nonlinear solve (steady: alpha0 = 0).  The GD weak form
        has no stabilization parameter, so the time step enters only
        through alpha0 and ``combo``.  A ``_sharded_hook`` (set by the
        apps for N shards, ``parallel/sharded_gd.py``) takes the solve
        over: ``hook(x0, combo, t, alpha0) -> NewtonResult`` with the
        global solution; the orchestration around it stays the
        engine's."""
        t0 = _time.perf_counter()
        if self._sharded_hook is not None:
            res = self._sharded_hook(x0, combo, t, alpha0)
            record_solve(self.stats, res, _time.perf_counter() - t0,
                         self.newton_cfg.tolerance)
            return res
        op, mask = self.op, self._mask
        x0 = torch.where(mask, self._bc_values_flat(t), x0)
        x0 = self._hc_distribute(x0)
        fq = self._source_q(t)

        def residual(x):
            R = op.residual_free(self._hc_distribute(x), combo, fq, alpha0)
            R = self._hc_transpose(R)
            return torch.where(mask, torch.zeros_like(R), R)

        def jacobian(x):
            state = op.linearize(self._hc_distribute(x), combo, fq, alpha0)

            def matvec(v):
                dR = self._hc_transpose(op.jvp(state,
                                               self._hc_distribute(v)))
                return torch.where(mask, torch.zeros_like(dR), dR)

            return matvec

        res = newton_solve(
            residual, jacobian, x0,
            precond_builder=self._precond_builder(alpha0),
            config=self.newton_cfg)
        if self.hc_v.n or self.hc_p.n:
            res = res._replace(u=self._hc_distribute(res.u))
        record_solve(self.stats, res, _time.perf_counter() - t0,
                     self.newton_cfg.tolerance)
        return res

    # ------------------------------------------------------------------
    def initial_condition(self):
        d, op = self.dim, self.op
        x = torch.zeros(op.n_dofs, dtype=self.dtype, device=self.device)
        ic = self.prm.initial_conditions
        if ic.type in ("nodal", "L2projection"):
            expr = VectorExpression(ic.uvwp)
            kw = dict(dtype=self.dtype, device=self.device)
            vv = expr.spatial(torch.as_tensor(op.space_v.nodes, **kw), 0.0)
            pv = expr.spatial(torch.as_tensor(op.space_p.nodes, **kw), 0.0)
            x = op.join(vv[:, :d], pv[:, d])
        return torch.where(self._mask, self._bc_values_flat(0.0), x)

    def solve_steady(self, x0=None):
        if x0 is None:
            x0 = self.initial_condition()
        res = self._newton(x0, self._zero_prev, 0.0, 0.0)
        return res.u, res

    def solve_transient_step(self, x, previous, t, dts, order):
        """One implicit BDF step; ``previous`` newest first."""
        alpha = bdf_coefficients(order, dts)
        combo = torch.zeros_like(self._zero_prev)
        for i in range(1, order + 1):
            vi, _ = self.op.split(previous[i - 1])
            combo = combo + float(alpha[i]) * vi
        res = self._newton(x, combo, t, float(alpha[0]))
        return res.u, res

    def solve_sdirk_step(self, x, t_old, dt, order):
        """One SDIRK22/33 step on the mixed state, the GLS engine's stage
        sequence with the velocity history only: each stage from the
        previous stage's state, k_s = alpha0 v_s + combo.  Returns
        (x_{n+1}, the last stage's NewtonResult)."""
        table = sdirk_coefficients(order, dt)
        A, c = table[:, :order], table[:, order]
        v_n, _ = self.op.split(x)
        ks = []
        res = None
        for s_i in range(order):
            gamma = A[s_i, s_i]
            alpha0 = 1.0 / (dt * gamma)
            combo = -v_n * alpha0
            for j in range(s_i):
                combo = combo - (A[s_i, j] / gamma) * ks[j]
            res = self._newton(x, combo, t_old + c[s_i] * dt, alpha0)
            x = res.u
            v_s, _ = self.op.split(x)
            ks.append(alpha0 * v_s + combo)
        return x, res

    # ------------------------------------------------------------------
    def solve(self, on_step=None):
        """Steady cycles (Kelly or uniform refinement between them, a
        Kelly cycle starting from the transferred solution) or the
        transient loop.  Returns the final solution."""
        prm = self.prm
        if not self.control.is_steady():
            return self.run_transient(on_step=on_step)
        x = None
        for cycle in range(prm.simulation_control.number_mesh_adaptation
                           + 1):
            x0 = None
            if cycle > 0:
                if prm.mesh_adaptation.type == "kelly":
                    x0 = self.refine_mesh_kelly([x])[0]
                else:
                    self.setup(self._mesh.refine_uniform(1))
            x, _ = self.solve_steady(x0=x0)
            if self.exact is not None:
                ev, ep = self.l2_errors(x)
                prec = prm.simulation_control.log_precision
                print(f"L2 error velocity : {ev:.{prec}e}  "
                      f"L2 error pressure: {ep:.{prec}e}")
            self.postprocess(x, 0.0)
        if prm.simulation_control.output_frequency > 0:
            self.write_output(x, 0.0)
        self.write_tables()
        return x

    def run_transient(self, x0=None, on_step=None):
        """The BDF or SDIRK time loop with the JAX package's startup
        sub-steps (BDF only, not after a restart), the restart read
        before them and a checkpoint after every ``frequency``-th
        step."""
        prm = self.prm
        ctrl = self.control
        sdirk_order = (int(ctrl.method.value[-1])
                       if ctrl.method.is_sdirk else 0)
        target_order = max(ctrl.method.bdf_order, 1)
        x = self.initial_condition() if x0 is None else x0
        previous = [x] * 3
        if prm.restart.restart:
            x, previous = self.read_checkpoint()
        s_scale = prm.simulation_control.startup_timestep_scaling
        startup_left = (target_order - 1
                        if (target_order >= 2 and not sdirk_order
                            and 0.0 < s_scale < 1.0
                            and not prm.restart.restart) else 0)
        prec = prm.simulation_control.log_precision
        while not ctrl.is_at_end():
            ctrl.integrate()
            order = ctrl.effective_bdf_order()
            t = ctrl.time
            if not prm.test.enable:
                print(f"*** Time step : {ctrl.iteration}  "
                      f"time = {t:.{prec}g}  dt = {ctrl.dt:.{prec}g} ***")
            with self.timer.section("solve"):
                if sdirk_order:
                    x, _ = self.solve_sdirk_step(x, t - ctrl.dt, ctrl.dt,
                                                 sdirk_order)
                elif startup_left > 0:
                    k = target_order - startup_left
                    dt_full = ctrl.dt_history[0]
                    dt_a = s_scale * dt_full
                    dt_b = dt_full - dt_a
                    dts_a = [dt_a] + ctrl.dt_history[1:]
                    x, _ = self.solve_transient_step(
                        x, previous, t - dt_b, dts_a, min(k, len(dts_a)))
                    previous = [x] + previous[:2]
                    dts_b = [dt_b, dt_a] + ctrl.dt_history[1:]
                    x, _ = self.solve_transient_step(
                        x, previous, t, dts_b, min(k + 1, len(dts_b)))
                    ctrl.dt_history = ([dt_b, dt_a]
                                       + ctrl.dt_history[1:])[:4]
                    startup_left -= 1
                else:
                    x, _ = self.solve_transient_step(
                        x, previous, t, ctrl.dts(), order)
            ctrl.cfl = float(self.op.cfl(x, ctrl.dt))
            previous = [x] + previous[:2]
            with self.timer.section("postprocess"):
                self.postprocess(x, t)
                if self.exact is not None and prm.test.enable:
                    ev, _ = self.l2_errors(x, t)
                    print(f"L2 error velocity : {ev:.{prec}e}")
            if ctrl.is_output_iteration():
                self.write_output(x, t)
            ma = prm.mesh_adaptation
            if (ma.type == "kelly" and ma.frequency > 0
                    and ctrl.iteration % ma.frequency == 0):
                # the solution and the BDF history move to the new mesh
                fields = self.refine_mesh_kelly([x] + previous)
                x, previous = fields[0], list(fields[1:])
            # the checkpoint comes after the adaptation, as in the GLS
            # engine
            if (prm.restart.checkpoint
                    and ctrl.iteration % prm.restart.frequency == 0):
                self.write_checkpoint(x, previous)
            if on_step is not None:
                on_step(self, x, t)
        self.write_tables()
        if prm.timer.type == "end":
            print(self.timer.report())
        return x

    # ------------------------------------------------------------------
    def refine_mesh_kelly(self, fields: list):
        """Kelly estimate on the velocity (through an equal-order view of
        the velocity space) -> flag -> forest coarsen/refine/balance ->
        rebuild both spaces -> transfer every flat mixed field, its
        velocity and pressure each on its own space."""
        if self.forest is None:
            raise ValueError("kelly adaptation requires the forest path "
                             "(set mesh adaptation type = kelly)")
        ma = self.prm.mesh_adaptation
        op = self.op
        view = SimpleNamespace(space=op.space_v, dim=self.dim,
                               xe=op.space_v.element_coords(),
                               elem_nodes=op.space_v.elem_nodes)
        v0, _ = op.split(fields[0])
        eta = kelly_estimate(view, v0.detach().cpu().numpy(),
                             variable="velocity", nc_faces=self._nc_faces)
        E = op.space_v.mesh.n_cells
        old_sv, old_sp = op.space_v, op.space_p
        old_elem_of = self._elem_of
        snap = snapshot_forest(self.forest)
        adapt_forest(self.forest, eta, ma, self.dim)
        mesh, self._elem_of, ncf = self.forest.build_mesh()
        self.setup(mesh=mesh, nc_faces=ncf)
        out = []
        nsv, nsp = self.op.space_v, self.op.space_p
        for f in fields:
            v, p = op.split(f)
            (vn,) = transfer_solution(old_sv, snap, old_elem_of, nsv,
                                      self.forest, self._elem_of, [v])
            (pn,) = transfer_solution(old_sp, snap, old_elem_of, nsp,
                                      self.forest, self._elem_of,
                                      [p[:, None]])
            out.append(self.op.join(vn, pn[:, 0]))
        if not self.prm.test.enable:
            print(f"Mesh adaptation: {E} -> {self.op.space_v.mesh.n_cells}"
                  f" cells, {self.op.n_dofs} dofs")
        return out

    # ------------------------------------------------------------------
    def _pin_pressure(self, x):
        """Zero the volume-weighted mean pressure before force/torque
        integration when no outlet BC fixes the pressure level (the
        constant mode is free on all-Dirichlet decks); on the host in
        float64."""
        if any(bc.type == BoundaryType.outlet
               for bc in self.prm.boundary_conditions.bcs):
            return x
        op = self.op
        J = np.einsum("eni,qnj->eqij", op.space_v.element_coords(),
                      op.Gv.cpu().double().numpy())
        wdet = np.linalg.det(J) * op.w.cpu().double().numpy()
        x_np = x.detach().cpu().double().numpy()
        pe = x_np[op.Nv * self.dim:][op.space_p.elem_nodes]
        pq = np.einsum("qn,en->eq", op.Bp.cpu().double().numpy(), pe)
        mean = float(np.sum(wdet * pq) / wdet.sum())
        v, p = op.split(x)
        return op.join(v, p - mean)

    def postprocess(self, x, t: float) -> None:
        prm = self.prm
        prec = prm.forces.output_precision
        it = self.control.iteration
        sv = self.op.space_v
        forces_now = it % prm.forces.calculation_frequency == 0
        if (prm.forces.calculate_forces
                or prm.forces.calculate_torques) and forces_now:
            x = self._pin_pressure(x)
        if prm.forces.calculate_forces and forces_now:
            for bid, faces in sorted(sv.boundary_faces.items()):
                f = post.gd_forces_on_boundary(self.op, x, faces)
                f = f.cpu().numpy()
                tab = self._force_tables.setdefault(
                    bid, Table(["time"] + [f"f_{ax}" for ax in
                                           "xyz"[:self.dim]],
                               precision=prec))
                tab.add_row([t] + list(map(float, f)))
                if prm.forces.verbosity is Verbosity.verbose \
                        or prm.test.enable:
                    lp = prm.simulation_control.log_precision
                    comps = " ".join(f"{v:.{lp}e}" for v in f)
                    print(f"Force boundary {bid} : {comps}")
        if prm.forces.calculate_torques and forces_now:
            cor = {bc.id: np.asarray(bc.center_of_rotation(self.dim))
                   for bc in prm.boundary_conditions.bcs}
            for bid, faces in sorted(sv.boundary_faces.items()):
                tq = post.gd_torques_on_boundary(
                    self.op, x, faces,
                    center=cor.get(bid, np.zeros(self.dim)))
                tq = tq.cpu().numpy()
                tab = self._torque_tables.setdefault(
                    bid, Table(["time"] + [f"T_{i}" for i in
                                           range(tq.shape[0])],
                               precision=prec))
                tab.add_row([t] + list(map(float, tq)))
        pp = prm.post_processing
        if (pp.calculate_kinetic_energy or pp.calculate_enstrophy) and \
                it % pp.calculation_frequency == 0:
            row = {"time": t}
            if pp.calculate_kinetic_energy:
                row["kinetic-energy"] = float(post.gd_kinetic_energy(self.op,
                                                                     x))
                self.tables["ke"].append((t, row["kinetic-energy"]))
            if pp.calculate_enstrophy:
                row["enstrophy"] = float(post.gd_enstrophy(self.op, x))
                self.tables["enstrophy"].append((t, row["enstrophy"]))
            if pp.verbosity is Verbosity.verbose or prm.test.enable:
                print("  ".join(f"{k}: {v:.6e}" for k, v in row.items()
                                if k != "time"))

    def write_tables(self) -> None:
        """Force/torque/KE/enstrophy tables as .dat files."""
        prm = self.prm
        outdir = prm.simulation_control.output_path
        for bid, tab in self._force_tables.items():
            tab.write(os.path.join(
                outdir, f"{prm.forces.force_output_name}.{bid}.dat"))
        for bid, tab in self._torque_tables.items():
            tab.write(os.path.join(
                outdir, f"{prm.forces.torque_output_name}.{bid}.dat"))
        pp = prm.post_processing
        for key, name in (("ke", pp.kinetic_energy_name),
                          ("enstrophy", pp.enstrophy_name)):
            if self.tables[key]:
                t = Table(["time", name])
                for row in self.tables[key]:
                    t.add_row(list(row))
                t.write(os.path.join(outdir, f"{name}.dat"))

    def write_output(self, x, t: float) -> None:
        """VTU on the velocity space; the Qk pressure is interpolated to
        the Q(k+1) nodes for visualization only."""
        sc = self.prm.simulation_control
        op = self.op
        sv, sp = op.space_v, op.space_p
        v, p = op.split(x)
        Bp_at_vn, _, _ = sp.basis.tabulate(sv.basis.nodes)
        pe = p.detach().cpu().numpy()[sp.elem_nodes]
        p_at_vn = np.einsum("nk,ek->en", Bp_at_vn, pe)
        p_nodes = np.zeros(op.Nv)
        counts = np.zeros(op.Nv)
        np.add.at(p_nodes, sv.elem_nodes.reshape(-1), p_at_vn.reshape(-1))
        np.add.at(counts, sv.elem_nodes.reshape(-1), 1.0)
        p_nodes /= np.maximum(counts, 1.0)
        cells = subcell_connectivity(sv.elem_nodes, sv.degree, self.dim)
        name = f"{sc.output_name}.{self.control.iteration:05d}.vtu"
        write_vtu(os.path.join(sc.output_path, name), sv.nodes, cells,
                  {"velocity": v.detach().cpu().numpy(),
                   "pressure": p_nodes})
        self.pvd.append(t, name)
        self.pvd.write(os.path.join(sc.output_path, sc.output_name + ".pvd"))

    # ------------------------------------------------------------------
    def write_checkpoint(self, x, previous) -> None:
        """The JAX GD engine's checkpoint: u and the history (newest
        first) in the run's dtype, the control and PVD state as JSON, the
        DoF count and on a forest its leaves and base mesh; written
        atomically."""
        extras = ({} if self.forest is None
                  else forest_checkpoint(self.forest))
        write_npz_atomic(
            checkpoint_path(self.prm), u=x.detach().cpu().numpy(),
            previous=np.stack([p.detach().cpu().numpy() for p in previous]),
            control=json.dumps(self.control.serialize()),
            pvd=json.dumps(self.pvd.serialize()), n_dofs=self.op.n_dofs,
            **extras)

    def read_checkpoint(self):
        """Restore the control and PVD state, and a checkpointed forest
        (both spaces rebuilt on it); returns (x, previous) in the run's
        dtype and device, from a checkpoint of either package."""
        data = load_checkpoint(checkpoint_path(self.prm))
        if "forest_leaves" in data:
            mesh, self._elem_of, ncf = restore_forest(self.forest, data)
            self.setup(mesh=mesh, nc_faces=ncf)
        if int(data["n_dofs"]) != self.op.n_dofs:
            raise ValueError("checkpoint does not match current mesh")
        self.control.deserialize(json.loads(str(data["control"])))
        self.pvd.deserialize(json.loads(str(data["pvd"])))
        kw = dict(dtype=self.dtype, device=self.device)
        return (torch.as_tensor(data["u"], **kw),
                [torch.as_tensor(p, **kw) for p in data["previous"]])

    def l2_errors(self, x, t=0.0):
        if self.exact is None:
            return None
        ev, ep = self.op.l2_errors(x, self.exact, t)
        return float(ev), float(ep)
