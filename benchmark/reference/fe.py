"""Tensor-product Lagrange elements on [0, 1]^d in float64, for the
plain reference.

Support points are equispaced (0, 1 for Q1; 0, 1/2, 1 for Q2), nodes
are numbered with coordinate 0 fastest, and the quadrature is the
tensor Gauss-Legendre rule.  Everything is NumPy on the host; the
tables go to the device once.
"""

from __future__ import annotations

import itertools

import numpy as np


def _lagrange_1d(degree: int):
    """Values, first and second derivatives of the 1D Lagrange basis on
    equispaced points, as functions of x[m] -> [m, degree + 1]."""
    pts = np.linspace(0.0, 1.0, degree + 1)
    polys = []
    for j in range(degree + 1):
        others = np.delete(pts, j)
        p = np.poly1d(others, r=True) / np.prod(pts[j] - others)
        polys.append((p, p.deriv(1), p.deriv(2)))

    def table(x, k):
        return np.stack([pp[k](x) for pp in polys], axis=-1)

    return pts, table


def gauss_1d(n: int):
    """n-point Gauss-Legendre rule on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def multi_indices(n1d: int, dim: int) -> np.ndarray:
    """[n1d^dim, dim] per-axis indices, coordinate 0 fastest."""
    rows = [idx[::-1] for idx in itertools.product(range(n1d), repeat=dim)]
    return np.asarray(rows, dtype=np.int64)


class Element:
    """Qk on [0, 1]^dim with an n_q1d-point Gauss rule per axis.

    B[q, n] values, G[q, n, a] gradients, H[q, n, a, b] Hessians (in
    reference coordinates), w[q] weights, support[n, dim] the nodes."""

    def __init__(self, dim: int, degree: int, n_q1d: int | None = None):
        self.dim, self.degree = dim, degree
        n_q1d = n_q1d or degree + 1
        pts1, tab = _lagrange_1d(degree)
        xq, wq = gauss_1d(n_q1d)
        nidx = multi_indices(degree + 1, dim)
        qidx = multi_indices(n_q1d, dim)
        self.support = pts1[nidx]
        self.w = np.prod(wq[qidx], axis=1)
        v = [tab(xq, k) for k in range(3)]        # [q1d, n1d] each
        nq, nn = len(qidx), len(nidx)
        B = np.ones((nq, nn))
        G = np.ones((nq, nn, dim))
        H = np.ones((nq, nn, dim, dim))
        for ax in range(dim):
            qa, na = qidx[:, ax][:, None], nidx[:, ax][None, :]
            B = B * v[0][qa, na]
            for a in range(dim):
                G[..., a] *= v[1 if a == ax else 0][qa, na]
                for b in range(dim):
                    k = (a == ax) + (b == ax)
                    H[..., a, b] *= v[k][qa, na]
        self.B, self.G, self.H = B, G, H

    def corner_weights(self, ref: np.ndarray) -> np.ndarray:
        """Multilinear corner weights at reference points [..., dim] ->
        [..., 2^dim], corner c's bit a the side of axis a."""
        dim = ref.shape[-1]
        out = np.ones(ref.shape[:-1] + (2 ** dim,))
        for c in range(2 ** dim):
            for a in range(dim):
                side = (c >> a) & 1
                out[..., c] *= ref[..., a] if side else 1.0 - ref[..., a]
        return out
