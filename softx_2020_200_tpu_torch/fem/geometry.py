"""Isoparametric geometry evaluation (counterpart of
``softx_2020_200_tpu.fem.geometry``).

Per-quad-point mapping Jacobians, determinants and inverses from element
node coordinates, in closed form over batched tensors.

Shapes: xe[E, nn, d] element node coords; G[nq, nn, d] reference-gradient
table (constant).
"""

from __future__ import annotations

import torch


def det_and_inv(J):
    """Closed-form determinant and inverse for batched 2x2 / 3x3 matrices."""
    d = J.shape[-1]
    if d == 1:
        det = J[..., 0, 0]
        inv = 1.0 / det
        return det, inv[..., None, None]
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, e = J[..., 1, 0], J[..., 1, 1]
        det = a * e - b * c
        idet = 1.0 / det
        inv = torch.stack([
            torch.stack([e * idet, -b * idet], dim=-1),
            torch.stack([-c * idet, a * idet], dim=-1),
        ], dim=-2)
        return det, inv
    if d == 3:
        m = J
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        det = (m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02)
        idet = 1.0 / det
        inv = torch.stack([
            torch.stack([c00, c10, c20], dim=-1),
            torch.stack([c01, c11, c21], dim=-1),
            torch.stack([c02, c12, c22], dim=-1),
        ], dim=-2) * idet[..., None, None]
        return det, inv
    raise ValueError(f"unsupported dim {d}")


def face_measure_and_normal(J, face: int):
    """Surface measure (Jacobian of the face parametrization) and outward
    unit normal at face quad points, from the volume mapping Jacobian J
    evaluated at the face points.

    J: [..., d, d]; face = 2*axis + side.
    """
    d = J.shape[-1]
    axis, side = divmod(face, 2)
    sign = -1.0 if side == 0 else 1.0
    if d == 2:
        t_axis = 1 - axis
        t = J[..., :, t_axis]                         # tangent vector
        meas = torch.linalg.norm(t, dim=-1)
        # rotate tangent by -90deg/+90deg to get outward normal
        n = torch.stack([t[..., 1], -t[..., 0]], dim=-1)
        # orientation: outward means pointing away from cell interior.
        # For face x_axis = 0 the outward dir is -dx/dxi_axis.
        ref = J[..., :, axis] * sign
        flip = torch.sign(torch.sum(n * ref, dim=-1, keepdim=True))
        n = n * flip / meas[..., None]
        return meas, n
    if d == 3:
        taxes = [a for a in range(3) if a != axis]
        t1 = J[..., :, taxes[0]]
        t2 = J[..., :, taxes[1]]
        n = torch.linalg.cross(t1, t2, dim=-1)
        meas = torch.linalg.norm(n, dim=-1)
        ref = J[..., :, axis] * sign
        flip = torch.sign(torch.sum(n * ref, dim=-1, keepdim=True))
        n = n * flip / meas[..., None]
        return meas, n
    raise ValueError(f"unsupported dim {d}")
