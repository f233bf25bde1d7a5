"""Boundary-condition application as device masks + value fields
(counterpart of ``softx_2020_200_tpu.solvers.boundary``).

Rebuild of the reference's ``NSBoundaryConditions`` + deal.II
``AffineConstraints`` Dirichlet handling (SURVEY.md §2.1): instead of
constraint matrices, each Dirichlet DoF carries a boolean mask entry and
a (possibly time-dependent) value.  The residual is zeroed on masked DoFs
and the Jacobian acts as identity there (see ``GLSOperator.residual`` and
``element_matrices``), which reproduces the reference's
nonzero_constraints / zero_constraints Newton semantics.

- noslip:   velocity components masked, value 0
- function: velocity components masked, values from deck expressions
- slip:     normal component masked on axis-aligned boundaries; on
            CURVED/non-aligned boundaries the constraint u.n = 0 is a
            rotated nodal frame (area-weighted nodal normals, residual
            tangentialized + normal-identity row — deal.II's
            compute_no_normal_flux_constraints analogue)
- periodic: handled topologically by FESpace node fusion (no runtime work)
- outlet:   natural (do-nothing)
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.expressions import Expression
from ..core.parameters import BoundaryConditionsParams, BoundaryType
from ..fem.dof import FESpace
from ..fem.geometry import face_measure_and_normal


class BoundaryHandler:
    def __init__(self, space: FESpace, bcs: BoundaryConditionsParams, *,
                 dtype: torch.dtype = torch.float64,
                 device: torch.device | str = "cpu"):
        self.space = space
        dim = space.dim
        nc = dim + 1
        N = space.n_nodes
        mask = np.zeros((N, nc), dtype=bool)
        # list of (node_indices, [Expression per velocity component])
        self.function_entries: list[tuple[np.ndarray, list[Expression]]] = []
        slip_rotated: list[int] = []

        for bc in bcs.bcs:
            if bc.type == BoundaryType.periodic:
                continue  # fused at FESpace build
            nodes = space.boundary_nodes.get(bc.id)
            if nodes is None or nodes.size == 0:
                continue
            if bc.type in (BoundaryType.noslip, BoundaryType.function):
                mask[nodes, :dim] = True
                if bc.type == BoundaryType.function:
                    exprs = [Expression(bc.u), Expression(bc.v)]
                    if dim == 3:
                        exprs.append(Expression(bc.w))
                    self.function_entries.append((nodes, exprs))
            elif bc.type == BoundaryType.slip:
                groups = self._slip_axis_groups(bc.id)
                if groups is not None:
                    # every face of the boundary is an axis-aligned level
                    # set (possibly different axes per face, e.g. one id
                    # covering the y+- AND z+- channel walls): constrain
                    # the per-face normal component through the plain
                    # Dirichlet mask.  Critical for the GMG/sharded
                    # paths, which understand masks but not rotated
                    # frames — the rotated fallback silently left such
                    # walls unconstrained in the sharded SPMD solve and
                    # de-constrained on all GMG coarse levels
                    # (scripts/diag_sphere_gmg.py, VERDICT r3 Missing #1).
                    for axis, ax_nodes in groups:
                        mask[ax_nodes, axis] = True
                else:
                    # rotated frame: constrain u.n = 0 at nodal normals
                    slip_rotated.append(bc.id)
            elif bc.type == BoundaryType.outlet:
                pass
            else:
                raise ValueError(f"unhandled boundary type {bc.type}")

        # rotated slip frames (built after Dirichlet masks so stronger
        # conditions win at shared corner nodes)
        slip_ids = []
        slip_normals = []
        for bid in slip_rotated:
            nids, nrm = self._nodal_normals(bid)
            keep = ~mask[nids, :dim].any(axis=1)
            slip_ids.append(nids[keep])
            slip_normals.append(nrm[keep])
        if slip_ids:
            ids = np.concatenate(slip_ids)
            nrm = np.concatenate(slip_normals)
            ids, first = np.unique(ids, return_index=True)
            nrm = nrm[first]
            self.slip_nodes = torch.as_tensor(ids.astype(np.int64),
                                              device=device)
            self.slip_normals = torch.as_tensor(nrm, dtype=dtype,
                                                device=device)
        else:
            self.slip_nodes = torch.zeros(0, dtype=torch.int64,
                                          device=device)
            self.slip_normals = torch.zeros((0, dim), dtype=dtype,
                                            device=device)

        self.mask = torch.as_tensor(mask, device=device)
        self.node_coords = torch.as_tensor(space.nodes, dtype=dtype,
                                           device=device)

    # ------------------------------------------------------------------
    @property
    def n_slip(self) -> int:
        return int(self.slip_nodes.shape[0])

    def _nodal_normals(self, bid: int):
        """Area-weighted outward unit normals at the nodes of one
        boundary: (node_ids [S], normals [S, dim])."""
        space = self.space
        dim = space.dim
        basis = space.basis
        faces = np.asarray(space.boundary_faces[bid])
        xe_all = space.element_coords()
        acc = np.zeros((space.n_nodes, dim))
        for lf in np.unique(faces[:, 1]):
            sel = faces[faces[:, 1] == lf][:, 0]
            fpts, fwts, B, G, H = basis.face_quadrature(
                int(lf), space.degree + 1)
            xe = xe_all[sel]                           # [F, nn, d]
            J = np.einsum("fni,qnj->fqij", xe, G)
            meas, normal = face_measure_and_normal(torch.from_numpy(J),
                                                   int(lf))
            meas = meas.numpy()
            normal = normal.numpy()
            w_face = np.einsum("fq,q->f", meas, fwts)  # face areas
            n_face = np.einsum("fqd,fq,q->fd", normal, meas, fwts)
            fnodes = space.elem_nodes[sel][:, basis.face_nodes(int(lf))]
            np.add.at(acc, fnodes.reshape(-1),
                      np.repeat(n_face, fnodes.shape[1], axis=0))
        ids = np.unique(space.boundary_nodes[bid])
        nrm = acc[ids]
        nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True),
                          1e-300)
        return ids, nrm

    def slip_project(self, u):
        """Remove the normal velocity component at rotated-slip nodes."""
        if self.n_slip == 0:
            return u
        d = self.space.dim
        s, n = self.slip_nodes, self.slip_normals.to(u.dtype)
        us = u[s, :d]
        un = torch.einsum("sd,sd->s", us, n)
        u = u.clone()
        u[s, :d] = us - un[:, None] * n
        return u

    def slip_residual(self, R, u):
        """Tangentialize residual rows at rotated-slip nodes and install
        the normal-identity equation (R_n := u.n)."""
        if self.n_slip == 0:
            return R
        d = self.space.dim
        s = self.slip_nodes
        n = self.slip_normals.to(R.dtype)
        Rs = R[s, :d]
        Rn = torch.einsum("sd,sd->s", Rs, n)
        un = torch.einsum("sd,sd->s", u[s, :d], n)
        R = R.clone()
        R[s, :d] = Rs + (un - Rn)[:, None] * n
        return R

    def slip_project_blocks(self, blocks):
        """Project node-block Jacobians at rotated-slip nodes:
        B -> P B P + n n^T with P = I - n n^T (keeps the
        preconditioner consistent with the rotated rows)."""
        if self.n_slip == 0:
            return blocks
        d = self.space.dim
        s = self.slip_nodes
        n = self.slip_normals.to(blocks.dtype)          # [S, d]
        eye = torch.eye(d, dtype=blocks.dtype, device=blocks.device)
        P = eye[None] - n[:, :, None] * n[:, None, :]   # [S, d, d]
        Bs = blocks[s][:, :d, :d]
        Bs = torch.einsum("sij,sjk,skl->sil", P, Bs, P) \
            + n[:, :, None] * n[:, None, :]
        blocks = blocks.clone()
        blocks[s, :d, :d] = Bs
        return blocks

    # ------------------------------------------------------------------
    def _slip_axis_groups(self, bid: int):
        """Per-axis node groups of an everywhere-axis-aligned slip
        boundary, or None if any face is not a level set of its axis
        (genuinely curved/rotated boundary -> nodal-normal frames).

        Returns [(axis, node_ids)], one entry per axis present.  A node
        on two orthogonal walls of the same id (box edge) appears in
        both groups — both normal components are constrained, which is
        the correct no-normal-flux condition there.
        """
        faces = self.space.boundary_faces.get(bid)
        if faces is None or len(faces) == 0:
            return []
        space = self.space
        basis = space.basis
        xe = space.element_coords()
        nodes_by_axis: dict[int, list] = {}
        for (e, lf) in faces:
            axis = int(lf) // 2
            fn = basis.face_nodes(int(lf))
            fx = xe[int(e), fn]                          # [nfn, dim]
            size = max(np.ptp(fx, axis=0).max(), 1e-30)
            if np.ptp(fx[:, axis]) > 1e-8 * size:
                return None                              # rotated face
            nodes_by_axis.setdefault(axis, []).append(
                space.elem_nodes[int(e), fn])
        return [(ax, np.unique(np.concatenate(lst)))
                for ax, lst in sorted(nodes_by_axis.items())]

    def _slip_axis(self, bid: int) -> int:
        """Normal axis of an axis-aligned slip boundary.

        The local-face-index heuristic alone is insufficient: a curved
        boundary (O-grid cylinder surface) can present every face on one
        local axis while the physical normals rotate — so we ALSO verify
        geometrically that each face is a level set of the inferred axis.
        """
        faces = self.space.boundary_faces.get(bid)
        if faces is None or len(faces) == 0:
            raise ValueError(f"slip bc {bid}: no faces")
        axes = {int(lf) // 2 for (_, lf) in faces}
        if len(axes) != 1:
            raise NotImplementedError(
                "slip on non-axis-aligned boundaries requires rotated "
                "constraints (not yet implemented)")
        axis = axes.pop()
        space = self.space
        basis = space.basis
        xe = space.element_coords()
        for (e, lf) in faces:
            fx = xe[int(e), basis.face_nodes(int(lf))]      # [nfn, dim]
            size = max(np.ptp(fx, axis=0).max(), 1e-30)
            if np.ptp(fx[:, axis]) > 1e-8 * size:
                raise NotImplementedError(
                    f"slip bc {bid}: boundary face is not axis-aligned "
                    f"(normal rotates away from axis {axis}); rotated "
                    "slip constraints are not yet implemented")
        return axis

    # ------------------------------------------------------------------
    def values(self, t=0.0, node_coords=None):
        """Dirichlet value field [N, c] at time t."""
        dim = self.space.dim
        coords = node_coords if node_coords is not None else self.node_coords
        vals = torch.zeros((self.space.n_nodes, dim + 1),
                           dtype=coords.dtype, device=coords.device)
        for nodes, exprs in self.function_entries:
            idx = torch.as_tensor(nodes, device=coords.device)
            pts = coords[idx]
            for c, e in enumerate(exprs):
                vals[idx, c] = e.spatial(pts, t).to(vals.dtype)
        return vals

    def constrain(self, u, t=0.0, mask=None, node_coords=None):
        """Impose Dirichlet values on the solution (nonzero constraints)."""
        mask = mask if mask is not None else self.mask
        return torch.where(mask, self.values(t, node_coords).to(u.dtype), u)
