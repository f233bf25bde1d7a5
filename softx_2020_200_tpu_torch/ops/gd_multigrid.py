"""Geometric multigrid for the velocity block of the grad-div
Taylor-Hood (GD) Jacobian (counterpart of the lattice branch of
``softx_2020_200_tpu.ops.gd_multigrid``).

A V-cycle on the linearized velocity block

    A v = alpha0 (v, w) + ((u.grad)v + (v.grad)u, w)
        + nu (grad v, grad w) + gamma (div v, div w),

which is linear in v, so each level's matvec is a direct evaluation
(index gather, einsums, gather-sum assembly; no kernel and no jvp, as in
the JAX package on every device) and its node-block smoother is
assembled in closed form.  A structured lattice coarsens by halving; a
mesh in a forest coarsens through the forest (``ops/multigrid.py``),
each level with its own velocity hanging-node constraints (the matvec
is hc^T A hc on every level, the finest included); the velocity degree
stays.  The pressure Schur part of the block-triangular preconditioner
lives in ``solvers/gd.py``.

    smoother : damped (``OMEGA``) node-block Jacobi, one pre- and one
               post-smoothing step
    transfers: ``ops/multigrid.py``'s interpolation and its transpose;
               the linearization velocity is injected (lattice) or
               interpolated (forest)
    bottom   : GMRES(``COARSE_ITERS``) preconditioned by block-Jacobi,
               a fixed number of steps (``ops/linalg.py::gmres_fixed``),
               so a cycle reads nothing back from the device
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spans import track_state
from ..fem.dof import FESpace
from ..fem.mesh import subdivided_hyper_rectangle
from .batched_kernel import _det_inv_soa
from .linalg import gmres_fixed
from .multigrid import (Level, _coarsen_forest, _transfer_maps,
                        forest_transfers, hanging_level, prolong, restrict)
from .operators import assemble, build_assembly_map
from .preconditioners import apply_node_block_state, node_blocks_to_state

# the JAX package's cycle: one smoothing step each way, weight 0.7, a
# GMRES(20) bottom solve
N_SMOOTH, OMEGA, COARSE_ITERS = 1, 0.7, 20


class GDVelocityLevel:
    """The velocity-block operator on one velocity FESpace.

    Geometry (J^-1, det J * w and the physical basis gradients) is
    computed once in batch-minor layout; the linearization state (u and
    grad u at the quadrature points) is given per application.
    """

    def __init__(self, space_v: FESpace, nu: float, gamma: float,
                 n_q1d: int, *, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        self.space = space_v
        self.dim = space_v.dim
        self.nu = float(nu)
        self.gamma = float(gamma)
        self.N = space_v.n_nodes
        self.nn = space_v.basis.n_nodes
        kw = dict(dtype=dtype, device=device)
        _, wts, B, G, _ = space_v.basis.quadrature(n_q1d)
        self.B = torch.as_tensor(np.array(B), **kw)             # [q, nn]
        G = torch.as_tensor(np.array(G), **kw)                  # [q, nn, d]
        self.conn_t = torch.as_tensor(space_v.elem_nodes.T.astype(np.int64),
                                      device=device)            # [nn, E]
        self.amap_idx = build_assembly_map(
            space_v.elem_nodes, self.N).idx.to(device)
        xe_t = torch.as_tensor(np.ascontiguousarray(
            np.transpose(space_v.element_coords(), (1, 2, 0))), **kw)
        J = torch.einsum("niE,qnj->qijE", xe_t, G)
        detJ, Jinv = _det_inv_soa(J)
        w = torch.as_tensor(np.array(wts), **kw)
        self.scale = detJ * w[:, None]                          # [q, E]
        # physical basis gradients [q, nn, i, E]
        self.gB = torch.einsum("qna,qaiE->qniE", G, Jinv)
        self.eye = torch.eye(self.dim, **kw)

    def _soa(self, v):
        """Nodal v[N, d] -> element rows [nn, d, E]."""
        return v[self.conn_t].transpose(1, 2)

    def _assemble(self, r):
        """Element rows r[nn, k, E] -> assembled [N, k]."""
        return assemble(r.permute(2, 0, 1), self.amap_idx)

    # ------------------------------------------------------------------
    def lin_state(self, v_nodal):
        """(uq [q, d, E], guq [q, d, i, E]) at the linearization point."""
        ve_t = self._soa(v_nodal)
        uq = torch.einsum("qn,ndE->qdE", self.B, ve_t)
        guq = torch.einsum("qniE,ndE->qdiE", self.gB, ve_t)
        return uq, guq

    def matvec(self, v, uq, guq, alpha0):
        """A(u_lin) v on nodal velocity [N, d] -> [N, d]."""
        ve_t = self._soa(v)
        vq = torch.einsum("qn,ndE->qdE", self.B, ve_t)
        gv = torch.einsum("qniE,ndE->qdiE", self.gB, ve_t)
        conv = (torch.einsum("qdiE,qiE->qdE", gv, uq)
                + torch.einsum("qdiE,qiE->qdE", guq, vq))
        div = torch.einsum("qiiE->qE", gv)
        a_v = self.scale[:, None] * (alpha0 * vq + conv)
        a_g = self.scale[:, None, None] * (
            self.nu * gv
            + self.gamma * div[:, None, None] * self.eye[None, :, :, None])
        Rv = (torch.einsum("qn,qdE->ndE", self.B, a_v)
              + torch.einsum("qniE,qdiE->ndE", self.gB, a_g))
        return self._assemble(Rv)

    def node_blocks(self, uq, guq, alpha0):
        """Closed-form assembled node-diagonal blocks [N, d, d] (row:
        equation component, column: unknown component)."""
        d = self.dim
        blocks = element_velocity_blocks(self.B, self.gB, self.scale, uq,
                                         guq, alpha0, self.nu, self.gamma,
                                         self.eye)
        out = self._assemble(blocks.reshape(self.nn, d * d, -1))
        return out.reshape(self.N, d, d)


def element_velocity_blocks(B, gB, scale, uq, guq, alpha0, nu, gamma, eye):
    """The node-diagonal blocks of each element's velocity Jacobian in
    closed form, [nn, d, d, E] (row: equation component, column: unknown
    component), from the basis B [q, nn], the physical gradients
    gB [q, nn, i, E], det J * w [q, E] and the state uq, guq."""
    B2 = B * B                                              # [q, n]
    # scalar-diagonal contributions: mass + advection + viscosity
    m = torch.einsum("qE,qn->nE", scale, B2)
    adv = torch.einsum("qE,qn,qniE,qiE->nE", scale, B, gB, uq)
    lap = torch.einsum("qE,qniE,qniE->nE", scale, gB, gB)
    diag = alpha0 * m + adv + nu * lap                      # [n, E]
    # tensor contributions: reaction grad(u) + grad-div
    react = torch.einsum("qE,qn,qdiE->ndiE", scale, B2, guq)
    gdiv = gamma * torch.einsum("qE,qndE,qniE->ndiE", scale, gB, gB)
    return react + gdiv + diag[:, None, None, :] * eye[None, :, :, None]


# ----------------------------------------------------------------------
def _level_mask(space_v: FESpace, prm_bcs, dim: int, *, device):
    """Velocity Dirichlet mask [N, d] of one level."""
    from ..solvers.boundary import BoundaryHandler
    return BoundaryHandler(space_v, prm_bcs, device=device).mask[:, :dim]



def _face_centers(m, rows, dim: int):
    """Centres of boundary faces ``rows`` [(elem, local face, id)]: the
    corners of local face (axis, side) among the lex-ordered 2^d cell
    corners, averaged."""
    cen = np.empty((len(rows), dim))
    for i, (e, lf, _) in enumerate(rows):
        ax, sd = divmod(int(lf), 2)
        sel = [c for c in range(2 ** dim) if (c >> ax) & 1 == sd]
        cen[i] = m.vertices[m.cells[int(e), sel]].mean(0)
    return cen


def build_gd_hierarchy(solver, min_elems: int = 64,
                       max_levels: int = 10) -> list[Level]:
    """Velocity-block levels for a ``GDNavierStokesSolver``, finest
    first (``levels[0]`` on the solver's own velocity space).

    A structured lattice halves while every axis is even and the coarse
    lattice keeps ``min_elems`` cells; coarse boundary faces take the
    fine side's id, or on a side that carries several ids the id of the
    nearest fine boundary face, so a coarse Dirichlet mask never covers
    an outlet patch.  Any other mesh coarsens through the solver's forest
    when it has one (``_forest_levels``); without one it gets only its own
    level, and the solver then uses block-Jacobi."""
    op = solver.op
    d = solver.dim
    kw = dict(dtype=op.dtype, device=op.device)
    n_q1d = int(round(op.n_q ** (1.0 / d)))
    mask0 = solver._mask[:op.Nv * d].reshape(op.Nv, d)
    levels = [Level(op=op.velocity_level(), mask=mask0, hc=solver.hc_v)]
    mesh = op.space_v.mesh
    if mesh.structured_shape is None:
        if solver.forest is not None:
            _forest_levels(solver, levels, n_q1d, min_elems, max_levels)
        return levels
    ne = tuple(mesh.structured_shape)
    lo = mesh.vertices.min(axis=0)
    hi = mesh.vertices.max(axis=0)
    side_bid = {}
    for (_, lf, b) in mesh.boundary_faces:
        side_bid.setdefault(int(lf), set()).add(int(b))
    prev_space = op.space_v
    while (len(levels) < max_levels
           and all(n % 2 == 0 for n in ne)
           and int(np.prod(ne)) // (2 ** d) >= min_elems):
        ne = tuple(n // 2 for n in ne)
        cmesh = subdivided_hyper_rectangle(lo, hi, list(ne), colorize=True,
                                           dim=d)
        for row in cmesh.boundary_faces:
            ids = side_bid.get(int(row[1]))
            if ids is not None and len(ids) == 1:
                row[2] = next(iter(ids))
        for lf in (lf for lf, v in side_bid.items() if len(v) > 1):
            crows = [r for r in cmesh.boundary_faces if int(r[1]) == lf]
            frows = [r for r in mesh.boundary_faces if int(r[1]) == lf]
            if not crows or not frows:
                continue
            cc = _face_centers(cmesh, crows, d)
            fc = _face_centers(mesh, frows, d)
            fb = np.fromiter((int(r[2]) for r in frows), np.int64,
                             len(frows))
            near = np.argmin(((cc[:, None, :] - fc[None, :, :]) ** 2)
                             .sum(-1), axis=1)
            for r, j in zip(crows, near):
                r[2] = int(fb[j])
        cmesh.periodic = list(mesh.periodic)
        cspace = FESpace(cmesh, op.space_v.degree)
        masters, weights, inject = _transfer_maps(prev_space, cspace)
        levels.append(Level(
            op=GDVelocityLevel(cspace, op.nu, op.gamma, n_q1d, **kw),
            mask=_level_mask(cspace, solver.prm.boundary_conditions, d,
                             device=op.device),
            masters=torch.as_tensor(masters.astype(np.int64),
                                    device=op.device),
            weights=torch.as_tensor(weights, **kw),
            inject=torch.as_tensor(inject.astype(np.int64),
                                   device=op.device)))
        prev_space = cspace
    return levels


def _forest_levels(solver, levels, n_q1d, min_elems, max_levels) -> None:
    """Append the forest's velocity levels to ``levels``: one forest level
    coarser at a time while the level has more than ``min_elems`` cells
    and the forest still coarsens."""
    op, d = solver.op, solver.dim
    kw = dict(dtype=op.dtype, device=op.device)
    cur_forest, cur_space, cur_elem_of = (solver.forest, op.space_v,
                                          solver._elem_of)
    while len(levels) < max_levels and cur_space.n_elements > min_elems:
        cforest = _coarsen_forest(cur_forest)
        if cforest.n_leaves() >= cur_forest.n_leaves():
            break
        cmesh, c_elem_of, c_ncf = cforest.build_mesh()
        cmesh.periodic = list(op.space_v.mesh.periodic)
        cspace = FESpace(cmesh, op.space_v.degree)
        mask, hc = hanging_level(cspace, c_ncf,
                                 solver.prm.boundary_conditions, **kw)
        levels.append(Level(
            op=GDVelocityLevel(cspace, op.nu, op.gamma, n_q1d, **kw),
            mask=mask[:, :d], hc=hc, **forest_transfers(
                cur_space, cur_forest, cur_elem_of, cspace, cforest,
                c_elem_of, **kw)))
        cur_forest, cur_space, cur_elem_of = cforest, cspace, c_elem_of


# ----------------------------------------------------------------------
class GDCycle:
    """One velocity V-cycle of ``levels``, linearized once: ``states``
    holds per level the velocity at the quadrature points, its gradient,
    the Dirichlet mask and the block-Jacobi inverses, and the cycle's
    parts are methods.  Nothing in it refers back to it, so reference
    counting frees it, and every level's state with it, once the last
    reference to ``apply`` goes."""

    def __init__(self, levels, states, alpha0, *, n_smooth, omega,
                 coarse_iters):
        self.levels, self.states, self.alpha0 = levels, states, alpha0
        self.n_smooth, self.omega = n_smooth, omega
        self.coarse_iters = coarse_iters

    def matvec(self, level, v):
        lvl = self.levels[level]
        uq, guq, mask, _ = self.states[level]
        vin = lvl.hc_distribute(torch.where(mask, torch.zeros_like(v), v))
        out = lvl.hc_transpose(lvl.op.matvec(vin, uq, guq, self.alpha0))
        return torch.where(mask, v, out)

    def block_jacobi(self, level, v):
        return apply_node_block_state(self.states[level][3], v)

    def vcycle(self, level, r):
        mask, omega = self.states[level][2], self.omega
        if level + 1 == len(self.levels):
            shape = r.shape
            return gmres_fixed(
                lambda x: self.matvec(level, x.reshape(shape)).reshape(-1),
                r.reshape(-1),
                precond=lambda x: self.block_jacobi(
                    level, x.reshape(shape)).reshape(-1),
                m=self.coarse_iters).reshape(shape)
        z = omega * self.block_jacobi(level, r)
        for _ in range(self.n_smooth - 1):
            z = z + omega * self.block_jacobi(level,
                                              r - self.matvec(level, z))
        rc = restrict(self.levels[level + 1], r - self.matvec(level, z))
        rc = torch.where(self.states[level + 1][2], torch.zeros_like(rc),
                         rc)
        zf = prolong(self.levels[level + 1], self.vcycle(level + 1, rc))
        z = z + torch.where(mask, torch.zeros_like(zf), zf)
        return z + omega * self.block_jacobi(level, r - self.matvec(level, z))

    def apply(self, r):
        return self.vcycle(0, r)


def make_gd_vcycle(levels: list[Level], *, n_smooth: int = N_SMOOTH,
                   omega: float = OMEGA, coarse_iters: int = COARSE_ITERS):
    """builder(v_lin, alpha0) -> apply(r [N, d]): one velocity V-cycle
    linearized at the nodal velocity ``v_lin``; ``apply`` is a
    ``GDCycle``'s bound method, and the levels' state lives as long as
    it does."""

    def builder(v_lin, alpha0):
        # linearization velocities per level, injected (lattice) or
        # interpolated (forest) downward
        vs = [v_lin]
        for lvl in levels[1:]:
            vs.append(lvl.down(vs[-1]))

        states = []
        for lvl, v in zip(levels, vs):
            lv, mask = lvl.op, lvl.mask
            uq, guq = lv.lin_state(v)
            blocks = lv.node_blocks(uq, guq, alpha0)
            keep = (~mask).to(blocks.dtype)
            blocks = blocks * keep[:, :, None] * keep[:, None, :]
            states.append((uq, guq, mask, node_blocks_to_state(
                "block_jacobi", blocks, mask)))
        mg = GDCycle(levels, states, alpha0, n_smooth=n_smooth,
                     omega=omega, coarse_iters=coarse_iters)
        track_state(mg)
        return mg.apply

    return builder
