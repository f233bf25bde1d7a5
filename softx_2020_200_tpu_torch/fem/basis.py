"""Tensor-product Lagrange finite-element bases (FE_Q equivalent).

Replaces deal.II ``FE_Q<dim>`` + ``FEValues`` tabulation (SURVEY.md §2.5).
1D Lagrange polynomials on Gauss-Lobatto support points, tensor-multiplied
into [0,1]^dim.  All tabulation is host-side NumPy float64; the resulting
(B, G, H) tables are constants inside the jitted element kernels where the
actual contractions run on the MXU.

Node ordering: lexicographic with coordinate 0 fastest,
``n = i0 + (k+1)*i1 + (k+1)^2*i2`` — the same ordering used by
:func:`..fem.quadrature.tensor_quadrature` for points.
"""

from __future__ import annotations

import numpy as np

from .quadrature import gauss_lobatto_1d, tensor_quadrature


class LagrangeBasis1D:
    """Degree-k Lagrange basis on [0,1] with Gauss-Lobatto support points."""

    def __init__(self, degree: int):
        if degree < 1:
            raise ValueError("degree must be >= 1")
        self.degree = degree
        self.n = degree + 1
        if degree == 1:
            self.points = np.array([0.0, 1.0])
        else:
            self.points, _ = gauss_lobatto_1d(self.n)
            self.points[0], self.points[-1] = 0.0, 1.0
        # monomial coefficients: coeffs[j] solves V c = e_j with
        # V[i,m] = points[i]^m  ->  l_j(x) = sum_m coeffs[j,m] x^m
        V = np.vander(self.points, self.n, increasing=True)
        self.coeffs = np.linalg.solve(V, np.eye(self.n)).T  # [n, n]

    def eval(self, x: np.ndarray, deriv: int = 0) -> np.ndarray:
        """Evaluate all basis functions (or a derivative) at points x.

        Returns array [len(x), n]."""
        x = np.asarray(x, dtype=np.float64)
        out = np.zeros((x.shape[0], self.n))
        for j in range(self.n):
            c = self.coeffs[j].copy()
            for _ in range(deriv):
                c = np.polynomial.polynomial.polyder(c)
            out[:, j] = np.polynomial.polynomial.polyval(x, c)
        return out


def _lex_indices(n1d: int, dim: int) -> np.ndarray:
    """[nn, dim] array of per-axis indices in lexicographic order (axis 0
    fastest)."""
    nn = n1d ** dim
    idx = np.zeros((nn, dim), dtype=np.int64)
    for n in range(nn):
        rem = n
        for d in range(dim):
            idx[n, d] = rem % n1d
            rem //= n1d
    return idx


# (dim, degree, nq, pts-bytes) -> (B, G, H); see TensorBasis.tabulate
_TABULATE_CACHE: dict = {}


class TensorBasis:
    """Qk tensor-product basis on [0,1]^dim with full tabulation support."""

    def __init__(self, dim: int, degree: int):
        self.dim = dim
        self.degree = degree
        self.b1 = LagrangeBasis1D(degree)
        self.n1d = degree + 1
        self.n_nodes = self.n1d ** dim
        self.node_ij = _lex_indices(self.n1d, dim)      # [nn, dim]
        # reference node coordinates [nn, dim]
        self.nodes = self.b1.points[self.node_ij]

    # ------------------------------------------------------------------
    def tabulate(self, pts: np.ndarray):
        """Tabulate values, gradients, and Hessians at pts[nq, dim].

        Returns (B[nq,nn], G[nq,nn,dim], H[nq,nn,dim,dim]) — reference-
        coordinate derivatives.

        Memoized module-wide by (dim, degree, pts): every FESpace /
        GMG level / transfer space creates a fresh TensorBasis, and an
        adaptation cycle re-tabulates the same few point sets dozens of
        times (74 calls / 7 s of a profiled 50 s adapt).  Results are
        read-only views.
        """
        pts = np.asarray(pts, dtype=np.float64)
        # do not memoize huge point sets (the solution-transfer path
        # tabulates at EVERY node of a multi-million-node space; caching
        # those pins GBs of Hessian tables and hashes 10^8 bytes/key)
        if pts.shape[0] > 16384:
            return self._tabulate_impl(pts)
        key = (self.dim, self.degree, pts.shape[0], pts.tobytes())
        hit = _TABULATE_CACHE.get(key)
        if hit is not None:
            return hit
        out = self._tabulate_impl(pts)
        for a in out:
            a.setflags(write=False)
        if len(_TABULATE_CACHE) > 256:
            _TABULATE_CACHE.clear()
        _TABULATE_CACHE[key] = out
        return out

    def tabulate_values(self, pts: np.ndarray) -> np.ndarray:
        """B[nq, nn] only — no gradient/Hessian tables.

        The transfer/GMG-prolongation paths evaluate the basis at every
        node of the NEW space (10^6-10^7 points); tabulate() would
        allocate an [nq, nn, d, d] Hessian (1.6 GB at 2.8M Q1-3D points)
        that nobody reads."""
        pts = np.asarray(pts, dtype=np.float64)
        nq = pts.shape[0]
        val = [self.b1.eval(pts[:, d], 0) for d in range(self.dim)]
        ij = self.node_ij
        B = val[0][:, ij[:, 0]].copy()
        for d in range(1, self.dim):
            B *= val[d][:, ij[:, d]]
        return B

    def _tabulate_impl(self, pts: np.ndarray):
        nq = pts.shape[0]
        # per-axis 1D tables: val[d][nq, n1d], d1[d], d2[d]
        val = [self.b1.eval(pts[:, d], 0) for d in range(self.dim)]
        d1 = [self.b1.eval(pts[:, d], 1) for d in range(self.dim)]
        d2 = [self.b1.eval(pts[:, d], 2) for d in range(self.dim)]

        B = np.ones((nq, self.n_nodes))
        G = np.ones((nq, self.n_nodes, self.dim))
        H = np.ones((nq, self.n_nodes, self.dim, self.dim))
        ij = self.node_ij
        for d in range(self.dim):
            comp = val[d][:, ij[:, d]]          # [nq, nn]
            B *= comp
            for g in range(self.dim):
                G[:, :, g] *= d1[d][:, ij[:, d]] if g == d else comp
                for h in range(self.dim):
                    if g == h:
                        f = d2[d] if g == d else val[d]
                    elif d == g or d == h:
                        f = d1[d]
                    else:
                        f = val[d]
                    H[:, :, g, h] *= f[:, ij[:, d]]
        return B, G, H

    # ------------------------------------------------------------------
    def quadrature(self, n_q1d: int):
        """Volume quadrature + tabulation: (pts, wts, B, G, H)."""
        pts, wts = tensor_quadrature(n_q1d, self.dim)
        B, G, H = self.tabulate(pts)
        return pts, wts, B, G, H

    def face_quadrature(self, face: int, n_q1d: int):
        """Quadrature points of a local face embedded in the reference cell.

        Local face numbering follows the deal.II convention the reference
        uses: face = 2*axis + side (side 0 -> coord=0, side 1 -> coord=1).
        Returns (pts[nqf, dim], wts[nqf], B, G, H) with reference-cell
        tabulations at the face points; wts are the (dim-1)-dimensional
        reference weights.
        """
        axis, side = divmod(face, 2)
        if self.dim == 1:
            fpts = np.array([[float(side)]])
            fwts = np.array([1.0])
        else:
            sub_pts, fwts = tensor_quadrature(n_q1d, self.dim - 1)
            fpts = np.zeros((sub_pts.shape[0], self.dim))
            tang = [d for d in range(self.dim) if d != axis]
            for i, d in enumerate(tang):
                fpts[:, d] = sub_pts[:, i]
            fpts[:, axis] = float(side)
        B, G, H = self.tabulate(fpts)
        return fpts, fwts, B, G, H

    def face_nodes(self, face: int) -> np.ndarray:
        """Indices of the basis nodes lying on a local face."""
        axis, side = divmod(face, 2)
        target = 0 if side == 0 else self.degree
        return np.nonzero(self.node_ij[:, axis] == target)[0]

    @staticmethod
    def face_normal_axis(face: int) -> tuple[int, float]:
        axis, side = divmod(face, 2)
        return axis, (-1.0 if side == 0 else 1.0)
