"""Gauss-Legendre quadrature (1D + tensor product).

Replaces deal.II ``QGauss<dim>`` (SURVEY.md §2.5).  Host-side NumPy in
float64; the tabulated points/weights are baked into jitted kernels as
constants.
"""

from __future__ import annotations

import numpy as np


def gauss_legendre_1d(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [0, 1]. Exact for degree 2n-1."""
    if n < 1:
        raise ValueError("need at least one quadrature point")
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def gauss_lobatto_1d(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Lobatto-Legendre rule on [0, 1] (includes endpoints).

    Used for FE_Q-style support points; exact for degree 2n-3.
    """
    if n < 2:
        raise ValueError("Gauss-Lobatto needs at least 2 points")
    if n == 2:
        x = np.array([-1.0, 1.0])
    else:
        # interior points: roots of P'_{n-1}
        c = np.zeros(n)
        c[n - 1] = 1.0
        dP = np.polynomial.legendre.Legendre(c).deriv()
        x = np.concatenate([[-1.0], np.sort(dP.roots()), [1.0]])
    Pn1 = np.polynomial.legendre.Legendre(np.eye(n)[n - 1])
    w = 2.0 / (n * (n - 1) * Pn1(x) ** 2)
    return 0.5 * (x + 1.0), 0.5 * w


def tensor_quadrature(n_1d: int, dim: int) -> tuple[np.ndarray, np.ndarray]:
    """Tensor-product Gauss rule on [0,1]^dim.

    Returns (points[nq, dim], weights[nq]) in lexicographic order with the
    FIRST coordinate fastest — matching the tensor-product node ordering
    used throughout the framework.
    """
    x, w = gauss_legendre_1d(n_1d)
    pts_1d = [x] * dim
    wts_1d = [w] * dim
    grids = np.meshgrid(*pts_1d, indexing="ij")
    wgrids = np.meshgrid(*wts_1d, indexing="ij")
    # 'ij' meshgrid makes the LAST axis fastest when flattened with C-order
    # on the reversed list; build explicitly so coordinate 0 is fastest:
    n = n_1d ** dim
    pts = np.zeros((n, dim))
    wts = np.ones(n)
    for q in range(n):
        rem = q
        for d in range(dim):
            i = rem % n_1d
            rem //= n_1d
            pts[q, d] = x[i]
            wts[q] *= w[i]
    return pts, wts
