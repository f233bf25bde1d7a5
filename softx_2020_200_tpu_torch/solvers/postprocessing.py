"""Post-processing: forces, torques, kinetic energy, enstrophy and the
derived fields (vorticity, Q-criterion) (counterpart of
``softx_2020_200_tpu.solvers.postprocessing``).

The ``gd_*`` functions take the grad-div Taylor-Hood operator
(``solvers/gd.py::GDOperator``) and its flat mixed state.

Sign convention: returned forces/torques are those exerted BY the fluid
ON the boundary, i.e. integral of sigma . (-n) with n the fluid-domain
outward normal, sigma = -p I + nu (grad u + grad u^T).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.geometry import det_and_inv, face_measure_and_normal
from ..ops.operators import assemble


def _face_quantities(op, u, elems, local_face, n_q1d=None):
    """Values/gradients/geometry at the quad points of one local-face
    group of boundary faces.  Returns (uq, gradq, meas, normal, wts, xq).
    """
    space = op.space
    n_q1d = n_q1d or (space.degree + 1)
    _, fwts, B, G, _ = space.basis.face_quadrature(int(local_face), n_q1d)
    kw = dict(dtype=op.dtype, device=op.device)
    B = torch.as_tensor(np.array(B), **kw)
    G = torch.as_tensor(np.array(G), **kw)
    w = torch.as_tensor(np.array(fwts), **kw)

    sel = torch.as_tensor(elems, dtype=torch.int64, device=op.device)
    xe = op.xe[sel]                                   # [F, nn, d]
    ue = u[op.elem_nodes[sel]]                        # [F, nn, c]
    J = torch.einsum("fni,qnj->fqij", xe, G)
    _, Jinv = det_and_inv(J)
    meas, normal = face_measure_and_normal(J, int(local_face))
    uq = torch.einsum("qn,fnc->fqc", B, ue)
    du_dxi = torch.einsum("qna,fnc->fqca", G, ue)
    gradq = torch.einsum("fqca,fqai->fqci", du_dxi, Jinv)
    xq = torch.einsum("qn,fnd->fqd", B, xe)
    return uq, gradq, meas, normal, w, xq


def _traction(op, uq, gq, n):
    d = op.dim
    p = uq[..., d]
    gv = gq[..., :d, :]
    sym = gv + gv.transpose(-1, -2)
    return -p[..., None] * n + op.nu * torch.einsum("fqij,fqj->fqi", sym, n)


def forces_on_boundary(op, u, boundary_faces: np.ndarray):
    """Net force [d] exerted by the fluid on one boundary.

    boundary_faces: [(elem, local_face)] host array for one boundary id.
    """
    total = torch.zeros(op.dim, dtype=op.dtype, device=op.device)
    for lf in np.unique(boundary_faces[:, 1]):
        sel = boundary_faces[boundary_faces[:, 1] == lf][:, 0]
        uq, gq, meas, n, w, _ = _face_quantities(op, u, sel, int(lf))
        traction = _traction(op, uq, gq, n)
        total = total - torch.einsum("fqi,fq,q->i", traction, meas, w)
    return total


def torques_on_boundary(op, u, boundary_faces: np.ndarray, center):
    """Net torque about ``center`` exerted by the fluid on one boundary.
    2D: scalar z-torque [1]; 3D: vector [3]."""
    d = op.dim
    out = torch.zeros(1 if d == 2 else 3, dtype=op.dtype, device=op.device)
    center = torch.as_tensor(np.asarray(center), dtype=op.dtype,
                             device=op.device)
    for lf in np.unique(boundary_faces[:, 1]):
        sel = boundary_faces[boundary_faces[:, 1] == lf][:, 0]
        uq, gq, meas, n, w, xq = _face_quantities(op, u, sel, int(lf))
        traction = _traction(op, uq, gq, n)
        r = xq - center
        if d == 2:
            tz = r[..., 0] * traction[..., 1] - r[..., 1] * traction[..., 0]
            out = out - torch.einsum("fq,fq,q->", tz, meas, w)[None]
        else:
            tq = torch.linalg.cross(r, traction, dim=-1)
            out = out - torch.einsum("fqi,fq,q->i", tq, meas, w)
    return out


# --------------------------------------------------------------------------
# grad-div (Taylor-Hood) variants: velocity and pressure live in two
# spaces, so the face and volume integrals tabulate both bases at the
# velocity space's quadrature points (no interpolation of the pressure
# onto velocity nodes)
# --------------------------------------------------------------------------

def _gd_face_traction(gdop, x, elems, local_face, n_q1d=None):
    """(traction, meas, wts, xq) at the face quadrature points of one
    local-face group, for the GD mixed state x (flat [Nv*d + Np])."""
    sv, sp = gdop.space_v, gdop.space_p
    n_q1d = n_q1d or (sv.degree + 1)
    fpts, fwts, Bv, Gv, _ = sv.basis.face_quadrature(int(local_face), n_q1d)
    Bp, _, _ = sp.basis.tabulate(fpts)
    kw = dict(dtype=gdop.dtype, device=gdop.device)
    Bv, Gv, Bp, w = (torch.as_tensor(np.array(a), **kw)
                     for a in (Bv, Gv, Bp, fwts))

    v, p = gdop.split(x)
    sel = torch.as_tensor(elems, dtype=torch.int64, device=gdop.device)
    xe = gdop.xe[sel]                                 # [F, nnv, d]
    ve = v[gdop.conn_v[sel]]                          # [F, nnv, d]
    pe = p[gdop.conn_p[sel]]                          # [F, nnp]
    J = torch.einsum("fni,qnj->fqij", xe, Gv)
    _, Jinv = det_and_inv(J)
    meas, normal = face_measure_and_normal(J, int(local_face))
    pq = torch.einsum("qn,fn->fq", Bp, pe)
    dv_dxi = torch.einsum("qna,fnc->fqca", Gv, ve)
    gv = torch.einsum("fqca,fqai->fqci", dv_dxi, Jinv)
    sym = gv + gv.transpose(-1, -2)
    traction = (-pq[..., None] * normal
                + gdop.nu * torch.einsum("fqij,fqj->fqi", sym, normal))
    xq = torch.einsum("qn,fnd->fqd", Bv, xe)
    return traction, meas, w, xq


def gd_forces_on_boundary(gdop, x, boundary_faces: np.ndarray):
    """Net force [d] the fluid exerts on one boundary (GD mixed state)."""
    total = torch.zeros(gdop.dim, dtype=gdop.dtype, device=gdop.device)
    for lf in np.unique(boundary_faces[:, 1]):
        sel = boundary_faces[boundary_faces[:, 1] == lf][:, 0]
        tr, meas, w, _ = _gd_face_traction(gdop, x, sel, int(lf))
        total = total - torch.einsum("fqi,fq,q->i", tr, meas, w)
    return total


def gd_torques_on_boundary(gdop, x, boundary_faces: np.ndarray, center):
    """Net torque about ``center`` the fluid exerts on one boundary (GD
    mixed state).  2D: scalar z-torque [1]; 3D: vector [3]."""
    d = gdop.dim
    out = torch.zeros(1 if d == 2 else 3, dtype=gdop.dtype,
                      device=gdop.device)
    center = torch.as_tensor(np.asarray(center), dtype=gdop.dtype,
                             device=gdop.device)
    for lf in np.unique(boundary_faces[:, 1]):
        sel = boundary_faces[boundary_faces[:, 1] == lf][:, 0]
        tr, meas, w, xq = _gd_face_traction(gdop, x, sel, int(lf))
        r = xq - center
        if d == 2:
            tz = r[..., 0] * tr[..., 1] - r[..., 1] * tr[..., 0]
            out = out - torch.einsum("fq,fq,q->", tz, meas, w)[None]
        else:
            out = out - torch.einsum("fqi,fq,q->i",
                                     torch.linalg.cross(r, tr, dim=-1),
                                     meas, w)
    return out


def _gd_volume(gdop):
    """(det J * w [E, q], J^-1 [E, q, d, d]) on the velocity geometry."""
    J = torch.einsum("eni,qnj->eqij", gdop.xe, gdop.Gv)
    detJ, Jinv = det_and_inv(J)
    return detJ * gdop.w[None, :], Jinv


def gd_kinetic_energy(gdop, x):
    """Domain-averaged kinetic energy of the GD mixed state."""
    v, _ = gdop.split(x)
    vq = torch.einsum("qn,enc->eqc", gdop.Bv, v[gdop.conn_v])
    wdet, _ = _gd_volume(gdop)
    return 0.5 * torch.sum(wdet * torch.sum(vq * vq, dim=-1)) / torch.sum(
        wdet)


def gd_enstrophy(gdop, x):
    """Domain-averaged enstrophy of the GD mixed state."""
    v, _ = gdop.split(x)
    wdet, Jinv = _gd_volume(gdop)
    dv_dxi = torch.einsum("qna,enc->eqca", gdop.Gv, v[gdop.conn_v])
    grad = torch.einsum("eqca,eqai->eqci", dv_dxi, Jinv)
    if gdop.dim == 2:
        om = (grad[..., 1, 0] - grad[..., 0, 1])[..., None]
    else:
        om = torch.stack([grad[..., 2, 1] - grad[..., 1, 2],
                          grad[..., 0, 2] - grad[..., 2, 0],
                          grad[..., 1, 0] - grad[..., 0, 1]], dim=-1)
    return 0.5 * torch.sum(wdet * torch.sum(om * om, dim=-1)) / torch.sum(
        wdet)


# --------------------------------------------------------------------------
# volume quantities: element chunks bound the [chunk, nq, c, d]
# intermediates at any mesh size
# --------------------------------------------------------------------------

_VCHUNK = 32768


def _volume_sums(op, u, with_grad: bool):
    """Chunked (vol, |u|^2, |grad u|^2, |omega|^2) volume integrals."""
    d = op.dim
    E = op.elem_nodes.shape[0]
    sums = torch.zeros(4, dtype=op.dtype, device=op.device)
    for s in range(0, E, _VCHUNK):
        en = op.elem_nodes[s:s + _VCHUNK]
        ue = u[en]                                     # [chunk, nn, c]
        J = torch.einsum("eni,qnj->eqij", op.xe[s:s + _VCHUNK], op.G)
        detJ, Jinv = det_and_inv(J)
        wdet = detJ * op.w[None, :]
        uq = torch.einsum("qn,enc->eqc", op.B, ue)[..., :d]
        part = [torch.sum(wdet), torch.sum(wdet * torch.sum(uq * uq, -1))]
        if with_grad:
            du_dxi = torch.einsum("qna,enc->eqca", op.G, ue)
            grad = torch.einsum("eqca,eqai->eqci", du_dxi, Jinv)[..., :d, :]
            if d == 2:
                om2 = (grad[..., 1, 0] - grad[..., 0, 1]) ** 2
            else:
                om2 = ((grad[..., 2, 1] - grad[..., 1, 2]) ** 2
                       + (grad[..., 0, 2] - grad[..., 2, 0]) ** 2
                       + (grad[..., 1, 0] - grad[..., 0, 1]) ** 2)
            part += [torch.sum(wdet * torch.sum(grad * grad, dim=(-1, -2))),
                     torch.sum(wdet * om2)]
        else:
            part += [torch.zeros_like(part[0])] * 2
        sums = sums + torch.stack(part)
    return sums


def kinetic_energy(op, u):
    """Domain-averaged kinetic energy (1/V) integral 1/2 |u|^2."""
    vol, e2, _, _ = _volume_sums(op, u, with_grad=False)
    return 0.5 * e2 / vol


def enstrophy(op, u):
    """Domain-averaged enstrophy (1/V) integral 1/2 |omega|^2."""
    vol, _, _, o2 = _volume_sums(op, u, with_grad=True)
    return 0.5 * o2 / vol


def ke_dissipation_rate(op, u):
    """(1/V) integral nu grad u : grad u (TGV dissipation diagnostics)."""
    vol, _, g2, _ = _volume_sums(op, u, with_grad=True)
    return op.nu * g2 / vol


# --------------------------------------------------------------------------
# derived nodal fields for output
# --------------------------------------------------------------------------

def _grad_at_nodes(op, u):
    """Velocity gradient averaged to nodes: [N, d, d]."""
    d = op.dim
    basis = op.space.basis
    _, Gn, _ = basis.tabulate(basis.nodes)     # tabulation AT ref nodes
    Gn = torch.as_tensor(np.array(Gn), dtype=op.dtype, device=op.device)
    ue = u[op.elem_nodes]
    J = torch.einsum("eni,qnj->eqij", op.xe, Gn)
    _, Jinv = det_and_inv(J)
    du_dxi = torch.einsum("qna,enc->eqca", Gn, ue[..., :d])
    grad = torch.einsum("eqca,eqai->eqci", du_dxi, Jinv)   # [E, nn, d, d]
    flat = grad.reshape(grad.shape[0], grad.shape[1], d * d)
    acc = assemble(flat, op.amap_idx) * op.inv_mult[:, None]
    return acc.reshape(op.n_nodes, d, d)


def vorticity_field(op, u):
    """Nodal vorticity: [N] (2D scalar) or [N, 3] (3D vector)."""
    g = _grad_at_nodes(op, u)
    if op.dim == 2:
        return g[:, 1, 0] - g[:, 0, 1]
    return torch.stack([
        g[:, 2, 1] - g[:, 1, 2],
        g[:, 0, 2] - g[:, 2, 0],
        g[:, 1, 0] - g[:, 0, 1]], dim=-1)


def q_criterion_field(op, u):
    """Nodal Q-criterion: Q = 1/2 (|Omega|^2 - |S|^2)."""
    g = _grad_at_nodes(op, u)
    S = 0.5 * (g + g.transpose(-1, -2))
    W = 0.5 * (g - g.transpose(-1, -2))
    return 0.5 * (torch.sum(W * W, dim=(-1, -2))
                  - torch.sum(S * S, dim=(-1, -2)))
