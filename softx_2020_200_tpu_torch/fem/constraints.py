"""Hanging-node constraints for non-conforming (adaptive) meshes.

Replaces deal.II ``AffineConstraints`` hanging-node rows (SURVEY.md
§2.5): on a 2:1-balanced forest, every fine-face node that does not
coincide with a coarse node is constrained to the coarse face's basis:

    u[hanging] = sum_m w_m u[master_m]

Application is two dense index ops (tiny H):
- ``distribute(u)``     sets constrained values (before element gather);
- ``distribute_transpose(R)`` accumulates constrained-row residuals into
  the master rows and zeroes them (after scatter-add).

The Newton system then acts on the constrained subspace exactly as the
reference's condensed matrix does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class HangingConstraints:
    ids: torch.Tensor      # [H] int64 (global hanging node ids)
    masters: torch.Tensor  # [H, M] int64
    weights: torch.Tensor  # [H, M] float

    @property
    def n(self) -> int:
        return int(self.ids.shape[0])

    def distribute(self, u):
        """u[N, c] with constrained slots overwritten by master combos."""
        if self.n == 0:
            return u
        vals = torch.einsum("hm,hmc->hc", self.weights.to(u.dtype),
                            u[self.masters])
        return u.index_put((self.ids,), vals)

    def distribute_transpose(self, R):
        """Move constrained-row residuals onto masters; zero them."""
        if self.n == 0:
            return R
        rh = R[self.ids]                                   # [H, c]
        contrib = self.weights.to(R.dtype)[:, :, None] * rh[:, None, :]
        R = R.index_put((self.masters.reshape(-1),),
                        contrib.reshape(-1, R.shape[1]), accumulate=True)
        return R.index_put((self.ids,), torch.zeros_like(rh))

    def to(self, device, dtype):
        """The constraints with weights in ``dtype`` on ``device``."""
        return HangingConstraints(ids=self.ids.to(device),
                                  masters=self.masters.to(device),
                                  weights=self.weights.to(device, dtype))


def build_hanging_constraints(space, nc_faces,
                              dtype=torch.float64) -> HangingConstraints:
    """Derive constraint rows from the forest's non-conforming faces.

    Vectorized over ALL faces at once (one ``b1.eval`` call for every
    constrained point in the mesh) — the per-face/per-node loop this
    replaces was the measured adaptation hot spot at >=10^5 leaves
    (26 s of 67 s at 238k leaves, dominated by 361k one-point
    polynomial evaluations).
    """
    basis = space.basis
    dim = space.dim
    n1d = basis.b1.n
    pts_1d = basis.b1.points                                # [n1d]

    def _empty():
        return HangingConstraints(
            ids=torch.zeros(0, dtype=torch.int64),
            masters=torch.zeros((0, 1), dtype=torch.int64),
            weights=torch.zeros((0, 1), dtype=dtype))

    if not nc_faces:
        return _empty()

    F = len(nc_faces)
    nt = dim - 1
    fine_face = np.fromiter((f.fine_face for f in nc_faces),
                            np.int64, F)
    coarse_face = np.fromiter((f.coarse_face for f in nc_faces),
                              np.int64, F)
    fine_elem = np.fromiter((f.fine_elem for f in nc_faces),
                            np.int64, F)
    coarse_elem = np.fromiter((f.coarse_elem for f in nc_faces),
                              np.int64, F)
    # tmap rows: (coarse tangent axis, flip, neighbor child bit)
    tmap = np.array([f.tmap for f in nc_faces],
                    np.int64).reshape(F, nt, 3)
    a2, flip, bit = tmap[:, :, 0], tmap[:, :, 1] != 0, tmap[:, :, 2]

    ij = basis.node_ij                                      # [nn, dim]
    face_tbl = np.stack([basis.face_nodes(fc)
                         for fc in range(2 * dim)])         # [2d, nfn]
    nfn = face_tbl.shape[1]
    # tangent axes of a face, by face-normal axis
    tax_tbl = np.array([[a for a in range(dim) if a != ax]
                        for ax in range(dim)], np.int64)    # [dim, nt]

    elem_nodes = np.asarray(space.elem_nodes)
    fine_l = face_tbl[fine_face]                            # [F, nfn]
    coarse_l = face_tbl[coarse_face]                        # [F, nfn]
    fine_g = elem_nodes[fine_elem[:, None], fine_l]         # [F, nfn]
    coarse_g = elem_nodes[coarse_elem[:, None], coarse_l]   # [F, nfn]

    # nodes shared with the coarse face are masters there, not hanging
    hang = ~(fine_g[:, :, None] == coarse_g[:, None, :]).any(-1)

    # per fine face-node, lattice index along each fine tangent axis
    taxes = tax_tbl[fine_face // 2]                         # [F, nt]
    x_idx = np.take_along_axis(
        ij[fine_l],                                         # [F,nfn,dim]
        np.broadcast_to(taxes[:, None, :], (F, nfn, nt)), axis=2)
    x_fine = pts_1d[x_idx]                                  # [F,nfn,nt]
    # map through the (possibly rotated/flipped) face frame onto the
    # coarse face's tangent coordinates
    x2 = np.where(flip[:, None, :], 1.0 - x_fine, x_fine)
    x_coarse = (bit[:, None, :] + x2) / 2.0                 # [F,nfn,nt]
    l1d = basis.b1.eval(x_coarse.ravel()).reshape(F, nfn, nt, n1d)

    # coarse face-node lattice index along each coarse tangent axis
    c_idx = np.take_along_axis(
        ij[coarse_l],
        np.broadcast_to(a2[:, None, :], (F, nfn, nt)), axis=2)

    w = np.ones((F, nfn, nfn))
    fi = np.arange(F)[:, None, None]
    li = np.arange(nfn)[None, :, None]
    for t in range(nt):
        # w[f, i, j] *= l1d[f, i, t, c_idx[f, j, t]]
        w = w * l1d[fi, li, t, c_idx[:, None, :, t]]

    g_flat = fine_g[hang]                                   # [K]
    if g_flat.size == 0:
        return _empty()
    w_flat = w[hang]                                        # [K, nfn]
    m_flat = np.broadcast_to(coarse_g[:, None, :],
                             (F, nfn, nfn))[hang]           # [K, nfn]
    # one row per hanging node: keep the FIRST face that constrains it
    # (face-major order — same tie-break the sequential builder used),
    # output sorted by global id
    ids, first = np.unique(g_flat, return_index=True)
    return HangingConstraints(
        ids=torch.from_numpy(ids.astype(np.int64)),
        masters=torch.from_numpy(m_flat[first].astype(np.int64)),
        weights=torch.as_tensor(w_flat[first], dtype=dtype))
