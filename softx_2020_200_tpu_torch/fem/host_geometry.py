"""Isoparametric geometry on the host, in NumPy (copies of
``softx_2020_200_tpu.fem.geometry.det_and_inv`` and
``face_measure_and_normal`` with ``xp=np``).

The Kelly estimator (``solvers/kelly.py``) evaluates mapping Jacobians,
face measures and normals on the host, once per adaptation; the device
versions of the same formulas are ``fem/geometry.py``.  The bodies are
the JAX package's, which branch on ``xp is not jnp``: here every call is
NumPy, so ``jnp`` names no array module and the host branch is taken.
"""

from __future__ import annotations

import numpy as np

# the JAX package's device array module, which this package does not have
jnp = None


def det_and_inv(J, xp=np):
    """Closed-form determinant and inverse for batched 2x2 / 3x3
    matrices, in NumPy (``xp``): in 3D the cofactors are written straight
    into one preallocated inverse."""
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
        inv = xp.stack([
            xp.stack([e * idet, -b * idet], axis=-1),
            xp.stack([-c * idet, a * idet], axis=-1),
        ], axis=-2)
        return det, inv
    if d == 3:
        m = J
        if xp is not jnp:
            # host fast path: write cofactors straight into a
            # preallocated inverse — xp.stack of 9 big [F, q] cofactor
            # arrays was a measured Kelly-estimator hotspot (np.stack
            # copies every operand twice)
            import numpy as _np
            inv = _np.empty_like(m)
            inv[..., 0, 0] = m[..., 1, 1] * m[..., 2, 2] \
                - m[..., 1, 2] * m[..., 2, 1]
            inv[..., 1, 0] = m[..., 1, 2] * m[..., 2, 0] \
                - m[..., 1, 0] * m[..., 2, 2]
            inv[..., 2, 0] = m[..., 1, 0] * m[..., 2, 1] \
                - m[..., 1, 1] * m[..., 2, 0]
            inv[..., 0, 1] = m[..., 0, 2] * m[..., 2, 1] \
                - m[..., 0, 1] * m[..., 2, 2]
            inv[..., 1, 1] = m[..., 0, 0] * m[..., 2, 2] \
                - m[..., 0, 2] * m[..., 2, 0]
            inv[..., 2, 1] = m[..., 0, 1] * m[..., 2, 0] \
                - m[..., 0, 0] * m[..., 2, 1]
            inv[..., 0, 2] = m[..., 0, 1] * m[..., 1, 2] \
                - m[..., 0, 2] * m[..., 1, 1]
            inv[..., 1, 2] = m[..., 0, 2] * m[..., 1, 0] \
                - m[..., 0, 0] * m[..., 1, 2]
            inv[..., 2, 2] = m[..., 0, 0] * m[..., 1, 1] \
                - m[..., 0, 1] * m[..., 1, 0]
            det = (m[..., 0, 0] * inv[..., 0, 0]
                   + m[..., 0, 1] * inv[..., 1, 0]
                   + m[..., 0, 2] * inv[..., 2, 0])
            inv /= det[..., None, None]
            return det, inv
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
        inv = xp.stack([
            xp.stack([c00, c10, c20], axis=-1),
            xp.stack([c01, c11, c21], axis=-1),
            xp.stack([c02, c12, c22], axis=-1),
        ], axis=-2) * idet[..., None, None]
        return det, inv
    raise ValueError(f"unsupported dim {d}")


def face_measure_and_normal(J, face: int, xp=np):
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
        meas = xp.linalg.norm(t, axis=-1)
        # rotate tangent by -90deg/+90deg to get outward normal
        n = xp.stack([t[..., 1], -t[..., 0]], axis=-1)
        # orientation: outward means pointing away from cell interior.
        # For face x_axis = 0 the outward dir is -dx/dxi_axis.
        ref = J[..., :, axis] * sign
        flip = xp.sign(xp.sum(n * ref, axis=-1, keepdims=True))
        n = n * flip / meas[..., None]
        return meas, n
    if d == 3:
        taxes = [a for a in range(3) if a != axis]
        t1 = J[..., :, taxes[0]]
        t2 = J[..., :, taxes[1]]
        n = xp.cross(t1, t2)
        meas = xp.linalg.norm(n, axis=-1)
        ref = J[..., :, axis] * sign
        flip = xp.sign(xp.sum(n * ref, axis=-1, keepdims=True))
        n = n * flip / meas[..., None]
        return meas, n
    raise ValueError(f"unsupported dim {d}")

