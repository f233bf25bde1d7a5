"""Closed-form batched small-matrix (1x1..4x4) determinants and
inverses, in batch-minor layout (counterpart of
``softx_2020_200_tpu.ops.smallmat``).

Matrices are stored MATRIX-DIMS-FIRST ([k, k, ...batch]), so every
intermediate is a batch-shaped vector and each operation is one
elementwise pass over the batch.
"""

from __future__ import annotations

import torch


def det_bm(A):
    """Determinant of [k, k, ...] for k in {1, 2, 3, 4} -> [...]."""
    k = A.shape[0]
    a = A
    if k == 1:
        return a[0, 0]
    if k == 2:
        return a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
    if k == 3:
        return (a[0, 0] * (a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1])
                - a[0, 1] * (a[1, 0] * a[2, 2] - a[1, 2] * a[2, 0])
                + a[0, 2] * (a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]))
    if k == 4:
        def m2(i, j, p, q):
            return (a[0, i] * a[1, j] - a[0, j] * a[1, i]) * \
                   (a[2, p] * a[3, q] - a[2, q] * a[3, p])
        return (m2(0, 1, 2, 3) - m2(0, 2, 1, 3) + m2(0, 3, 1, 2)
                + m2(1, 2, 0, 3) - m2(1, 3, 0, 2) + m2(2, 3, 0, 1))
    raise NotImplementedError(f"det_bm: k={k}")


def _cof3_bm(a, rows, cols):
    (r0, r1, r2), (c0, c1, c2) = rows, cols
    return (a[r0, c0] * (a[r1, c1] * a[r2, c2] - a[r1, c2] * a[r2, c1])
            - a[r0, c1] * (a[r1, c0] * a[r2, c2] - a[r1, c2] * a[r2, c0])
            + a[r0, c2] * (a[r1, c0] * a[r2, c1] - a[r1, c1] * a[r2, c0]))


def inv_bm(A, det=None):
    """Inverse of [k, k, ...] -> [k, k, ...] via the adjugate.

    Caller regularizes singular blocks beforehand (test ``det_bm``
    against a threshold).
    """
    k = A.shape[0]
    a = A
    d = det if det is not None else det_bm(A)
    inv_d = 1.0 / d
    if k == 1:
        return inv_d[None, None]
    if k == 2:
        rows = [[a[1, 1], -a[0, 1]], [-a[1, 0], a[0, 0]]]
        return torch.stack([torch.stack(r) for r in rows]) * inv_d
    idx = list(range(k))

    def cof(i, j):
        rows = [r for r in idx if r != i]
        cols = [c for c in idx if c != j]
        if k == 3:
            m = (a[rows[0], cols[0]] * a[rows[1], cols[1]]
                 - a[rows[0], cols[1]] * a[rows[1], cols[0]])
        elif k == 4:
            m = _cof3_bm(a, rows, cols)
        else:
            raise NotImplementedError(f"inv_bm: k={k}")
        return m if (i + j) % 2 == 0 else -m

    # adjugate transpose: inv[i][j] = cof(j, i) / det
    out = [[cof(j, i) for j in idx] for i in idx]
    return torch.stack([torch.stack(r) for r in out]) * inv_d
