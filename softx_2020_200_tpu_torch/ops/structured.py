"""Structured-lattice gather/scatter as strided views (counterpart of
``softx_2020_200_tpu.ops.structured``).

On a logically Cartesian block the element-node gather is a set of
strided window reads of the node grid, and the assembly is a set of
overlapping strided window adds: no index arrays anywhere.  In torch a
window read is a strided slice ``g[o0::k, o1::k]`` and a window add is
``+=`` into the same strided view, which needs no atomics and sums in a
fixed order.

What this module relies on (checked at build, as in the JAX package):
- the FESpace node numbering is the C order of the node lattice
  ``[m0, m1(, m2)]``;
- the basis nodes are lexicographic with axis 0 fastest
  (``n = i0 + n1d*i1 + n1d^2*i2``);
- this path's element order is the C order of the element lattice
  (``elem_perm`` maps it to the space's element order).

Periodic axes take one halo layer before the gather and fold it back
after the scatter.  The JAX package's residue decomposition for degree
>= 2 is a TPU tile-padding device; the windows here read the same
entries directly, with the same results.
"""

from __future__ import annotations

import numpy as np
import torch


class StructuredLayout:
    def __init__(self, space):
        mesh = space.mesh
        if mesh.structured_shape is None:
            raise ValueError("mesh is not a structured block")
        self.dim = space.dim
        self.degree = k = space.degree
        self.ne = tuple(int(x) for x in mesh.structured_shape)
        self.periodic = tuple(any(pax == a for (_, _, pax) in mesh.periodic)
                              for a in range(self.dim))
        # node lattice dims (slaves removed on periodic axes)
        self.m = tuple(k * n + (0 if p else 1)
                       for n, p in zip(self.ne, self.periodic))
        self.n1d = k + 1
        self.nn = self.n1d ** self.dim
        N = int(np.prod(self.m))
        if N != space.n_nodes:
            raise ValueError(
                f"structured lattice {self.m} ({N}) != n_nodes "
                f"{space.n_nodes}")
        grid_coords = space.nodes.reshape(*self.m, self.dim)
        for a in range(self.dim):
            sl = [0] * self.dim
            sl[a] = slice(None)
            line = grid_coords[tuple(sl)][:, a]
            if not np.all(np.diff(line) > 0):
                raise ValueError("node numbering is not lattice C-order")

        self.E = int(np.prod(self.ne))
        self._nodes_grid = grid_coords
        # local node n -> its window offsets along each axis
        self.offsets = [tuple((n // self.n1d ** a) % self.n1d
                              for a in range(self.dim))
                        for n in range(self.nn)]

        # element permutation: this path's element order (element-lattice
        # C-order) vs the space's; per-element quantities in space order
        # (source terms fq) enter as fq[elem_perm]
        cent = space.element_coords().mean(axis=1)        # [E, dim]
        lo = cent.min(axis=0)
        hi = cent.max(axis=0)
        span = np.where(hi > lo, hi - lo, 1.0)
        idx = np.rint((cent - lo) / span
                      * (np.asarray(self.ne) - 1)).astype(np.int64)
        lin_c = np.ravel_multi_index(idx.T, self.ne, order="C")
        if len(np.unique(lin_c)) != self.E:
            raise ValueError("could not identify the element lattice "
                             "permutation (non-uniform structured mesh?)")
        perm = np.empty(self.E, dtype=np.int64)
        perm[lin_c] = np.arange(self.E)
        self.elem_perm = perm                             # grid -> space

    # ------------------------------------------------------------------
    def _window(self, g, offsets):
        """Strided view of the node grid for local node ``offsets``:
        [*ne, c]."""
        k = self.degree
        return g[tuple(slice(o, o + k * (n - 1) + 1, k)
                       for o, n in zip(offsets, self.ne))]

    def gather(self, u):
        """u [N, c] -> element rows [c, nn, E] (component-major, element
        index fastest; ``.reshape(c*nn, E)`` is the kernel's row
        layout).  The element windows are one strided view of the node
        grid (``unfold`` by k+1 with step k on each axis), copied once."""
        c, d, k = u.shape[-1], self.dim, self.degree
        g = u.reshape(*self.m, c)
        for a in range(d):
            if self.periodic[a]:
                g = torch.cat([g, g.narrow(a, 0, 1)], dim=a)
        for a in range(d):
            g = g.unfold(a, k + 1, k)          # [*ne, c, i0, .., i_{d-1}]
        # local node n = i0 + n1d*i1 (+ n1d^2*i2): axis 0 fastest
        order = [d] + [d + 1 + a for a in reversed(range(d))] + list(range(d))
        return g.permute(order).reshape(c, self.nn, self.E)

    def scatter(self, rows):
        """Element rows [c, nn, E] -> assembled [N, c] (overlapping
        strided window adds, then the periodic fold-back)."""
        c = rows.shape[0]
        k = self.degree
        ext = tuple(k * n + 1 for n in self.ne)
        R = rows.new_zeros(ext + (c,))
        blocks = rows.reshape((c, self.nn) + self.ne)
        for n, offs in enumerate(self.offsets):
            self._window(R, offs).add_(blocks[:, n].movedim(0, -1))
        # the halo is one layer (extended index k*ne is node 0 wrapped)
        for a in range(self.dim):
            if self.periodic[a]:
                m = self.m[a]
                R.narrow(a, 0, 1).add_(R.narrow(a, m, 1))
                R = R.narrow(a, 0, m)
        return R.reshape(-1, c)

    # ------------------------------------------------------------------
    def elem_coords_grid_order(self):
        """[E, nn, dim] element node coordinates in this path's element
        order (element-lattice C-order), host-side."""
        g = self._nodes_grid
        k = self.degree
        for a in range(self.dim):
            if self.periodic[a]:
                # the wrapped layer sits one period beyond the last plane;
                # the period is the span plus the first spacing
                head = np.take(g, np.arange(k), axis=a)
                lo = np.take(g, [0], axis=a)
                hi_span = (np.take(g, [g.shape[a] - 1], axis=a) - lo)
                d0 = (np.take(g, [1], axis=a) - lo)
                head = head + hi_span + d0
                g = np.concatenate([g, head], axis=a)
        out = np.zeros((self.E, self.nn, self.dim))
        for n, offs in enumerate(self.offsets):
            out[:, n, :] = self._window(g, offs).reshape(self.E, self.dim)
        return out
