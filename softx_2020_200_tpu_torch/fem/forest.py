"""Forest-of-quadtrees/octrees adaptive meshes (p4est replacement).

The reference delegates adaptive meshing to p4est (SURVEY.md §2.5):
forest of octrees over a coarse base mesh, 2:1-balanced refinement,
hanging nodes at non-conforming faces.  This module is the TPU-native
stand-in: leaves are integer-coordinate cells ``(level, i0, i1[, i2])``
inside each base cell; refinement/coarsening/balancing are host-side
integer set operations; ``build_mesh`` lowers the leaf set to the plain
array Mesh the rest of the framework consumes, together with the
non-conforming face list that drives hanging-node constraints and the
Kelly estimator.

Adjacent base cells may carry ROTATED/FLIPPED local frames (the O-ring
seam of the cylinder mesh, gmsh imports): every base-face pair stores a
full tangent-frame transform (axis permutation + per-axis flip), applied
when leaf coordinates cross the face — the forest analogue of p4est's
face connectivity orientation codes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .mesh import Mesh, place_nodes, _mesh_tolerance

Leaf = tuple  # (level, i0, i1[, i2]) — ints, i in [0, 2^level)


@dataclass
class NonConformingFace:
    """A coarse|fine interface: the coarse cell's face is covered by
    2^(d-1) finer cell faces.

    ``tmap`` describes the fine->coarse tangent frame, one entry per
    FINE tangent axis in ascending order: (coarse_axis, flip, child_bit)
    — a fine reference coordinate x along that fine axis sits at
    coarse-face coordinate (child_bit + (1-x if flip else x)) / 2 along
    coarse_axis.  For unrotated adjacency this reduces to the plain
    child-position description."""
    coarse_elem: int          # element index in the built mesh
    coarse_face: int          # in the COARSE cell's frame
    fine_elem: int
    fine_face: int
    tmap: tuple               # ((coarse_axis, flip, child_bit), ...)


class Forest:
    def __init__(self, base: Mesh):
        self.base = base
        self.dim = base.dim
        # leaves per base cell
        self.leaves: list[set] = [
            {(0,) + (0,) * self.dim} for _ in range(base.n_cells)]
        self._adjacency = self._build_adjacency()

    # ------------------------------------------------------------------
    def _build_adjacency(self):
        """base cell adjacency with orientation: (b, face) ->
        (b', face', perm, flip).

        Crossing from cell b through `face` into b', leaf coordinates
        transform as j'[perm[a]] = (n-1-j[a]) if flip[a] else j[a] for
        every tangent axis a; the normal coordinate is set from face'.
        perm/flip are derived from the shared corner vertices (p4est's
        connectivity orientation, computed instead of encoded)."""
        base = self.base
        d = self.dim
        nc = 2 ** d
        faces: dict[tuple, list] = {}
        from .basis import _lex_indices
        corner_ij = _lex_indices(2, d)
        for b in range(base.n_cells):
            for f in range(2 * d):
                axis, side = divmod(f, 2)
                sel = [i for i in range(nc)
                       if corner_ij[i, axis] == (1 if side else 0)]
                key = tuple(sorted(int(base.cells[b, i]) for i in sel))
                faces.setdefault(key, []).append((b, f))

        def transform(b1, f1, b2, f2, gid_map=None):
            """(perm, flip) for crossing b1 -> b2 through f1|f2.

            ``gid_map`` translates b1-side corner gids to the matching
            b2-side gids for PERIODIC seams (no shared vertices)."""
            axis1, side1 = divmod(f1, 2)
            axis2, side2 = divmod(f2, 2)
            pos2 = {int(g): corner_ij[i]
                    for i, g in enumerate(base.cells[b2])}

            def corner1(bits):
                want = [bits.get(a, 0) for a in range(d)]
                for i in range(nc):
                    if list(corner_ij[i]) == want:
                        g = int(base.cells[b1, i])
                        return gid_map[g] if gid_map else g
                raise KeyError(bits)

            g0 = corner1({axis1: side1})
            p0 = pos2[g0]
            perm = [-1] * d
            flip = [False] * d
            perm[axis1] = axis2
            for a in range(d):
                if a == axis1:
                    continue
                ga = corner1({axis1: side1, a: 1})
                pa = pos2[ga]
                diff = [i for i in range(d) if pa[i] != p0[i]]
                if len(diff) != 1:
                    raise ValueError(
                        "degenerate base-face corner matching "
                        f"between cells {b1} and {b2}")
                a2 = diff[0]
                perm[a] = a2
                flip[a] = bool(pa[a2] == 0)
            return tuple(perm), tuple(flip)

        adj = {}
        for key, lst in faces.items():
            if len(lst) == 2:
                (b1, f1), (b2, f2) = lst
                adj[(b1, f1)] = (b2, f2) + transform(b1, f1, b2, f2)
                adj[(b2, f2)] = (b1, f1) + transform(b2, f2, b1, f1)

        # periodic seams (declared on the BASE mesh before the forest is
        # built): match boundary faces of the paired ids by coordinates
        # modulo the translation axis — p4est's periodic connectivity
        for (bid_a, bid_b, ax) in getattr(base, "periodic", []):
            by_bid: dict[int, list] = {}
            for (e, f, bid) in base.boundary_faces:
                by_bid.setdefault(int(bid), []).append((int(e), int(f)))
            fa_list = by_bid.get(int(bid_a), [])
            fb_list = by_bid.get(int(bid_b), [])
            if not fa_list or not fb_list:
                continue
            tol = _mesh_tolerance(base.vertices, base.cells)

            def face_corners(b, f):
                axis, side = divmod(f, 2)
                return [int(base.cells[b, i]) for i in range(nc)
                        if corner_ij[i, axis] == (1 if side else 0)]

            def tkey(gids):
                """face key from coordinates with the periodic axis
                projected out"""
                pts = base.vertices[gids].copy()
                pts[:, ax] = 0.0
                q = np.round(pts / tol).astype(np.int64)
                return tuple(sorted(map(tuple, q.tolist())))

            b_lookup = {}
            for (e2, f2) in fb_list:
                b_lookup[tkey(face_corners(e2, f2))] = (e2, f2)
            for (e1, f1) in fa_list:
                if (e1, f1) in adj:
                    continue
                partner = b_lookup.get(tkey(face_corners(e1, f1)))
                if partner is None:
                    raise ValueError(
                        f"periodic pair {bid_a}|{bid_b}: no matching "
                        f"base face for cell {e1} face {f1}")
                e2, f2 = partner
                ga = face_corners(e1, f1)
                gb = face_corners(e2, f2)
                qa = np.round(np.delete(base.vertices[ga], ax, axis=1)
                              / tol).astype(np.int64)
                qb = np.round(np.delete(base.vertices[gb], ax, axis=1)
                              / tol).astype(np.int64)
                look = {tuple(r): g for r, g in zip(qb.tolist(), gb)}
                gmap = {g: look[tuple(r)] for r, g in zip(qa.tolist(),
                                                          ga)}
                gmap_rev = {v: k for k, v in gmap.items()}
                adj[(e1, f1)] = (e2, f2) + transform(e1, f1, e2, f2,
                                                     gmap)
                adj[(e2, f2)] = (e1, f1) + transform(e2, f2, e1, f1,
                                                     gmap_rev)
        return adj

    # ------------------------------------------------------------------
    def n_leaves(self) -> int:
        return sum(len(s) for s in self.leaves)

    def _invalidate(self):
        self._arr_cache = None
        self._order_cache = None

    def all_leaves(self):
        """[(base, leaf)] in deterministic order (b-major, leaves in
        tuple-lexicographic order within each base cell)."""
        cache = getattr(self, "_order_cache", None)
        if cache is not None and cache[0] is self.leaves:
            return cache[1]
        b_arr, lvl, idx = self._leaf_arrays_only()
        rows = np.column_stack([lvl, idx]).tolist()
        out = list(zip(b_arr.tolist(), map(tuple, rows)))
        self._order_cache = (self.leaves, out)
        return out

    # ------------------------------------------------------------------
    # vectorized leaf machinery (SURVEY §7.1: the p4est replacement must
    # not do per-leaf Python work at production scale)
    # ------------------------------------------------------------------
    def _leaf_arrays_only(self):
        """(b_arr [E], lvl [E], idx [E, d]) in all_leaves order, cached
        until the next mutation.  The sort runs on packed int64 keys
        (identical order to sorted() of the leaf tuples) — the python
        per-leaf sort was the measured host hotspot of the adaptation
        pipeline at 10^6 leaves."""
        cache = getattr(self, "_arr_cache", None)
        if cache is not None and cache[0] is self.leaves:
            return cache[1]
        d = self.dim
        nb = len(self.leaves)
        counts = np.fromiter((len(s) for s in self.leaves), np.int64, nb)
        E = int(counts.sum())
        b_arr = np.repeat(np.arange(nb, dtype=np.int64), counts)
        if E:
            flat = np.fromiter(
                (x for s in self.leaves for leaf in s for x in leaf),
                np.int64, E * (d + 1)).reshape(E, d + 1)
        else:
            flat = np.zeros((0, d + 1), np.int64)
        key = self._pack_rows(np.column_stack([b_arr, flat]))
        perm = np.argsort(key, kind="stable")
        out = (b_arr, flat[perm, 0], flat[perm, 1:])
        self._arr_cache = (self.leaves, out)
        return out

    def _leaf_arrays(self):
        """(order, b_arr [E], lvl [E], idx [E, d]) in all_leaves order."""
        b_arr, lvl, idx = self._leaf_arrays_only()
        return self.all_leaves(), b_arr, lvl, idx

    def _pack_rows(self, rows: np.ndarray) -> np.ndarray:
        """Non-negative (b, lvl, idx...) rows -> order-preserving keys.

        Single-int64 bit packing when the budget fits (sorts/unique on
        int64 are 3-10x faster than byte-compare void keys — the
        measured balance() hot spot); big-endian void-byte fallback
        otherwise.  The bit layout is a FOREST property (not per-call)
        so table keys and query keys always agree."""
        spec = getattr(self, "_pack_spec", None)
        if spec is None:
            d = self.dim
            bits_b = max(1, int(len(self.leaves) - 1).bit_length())
            bits_lvl = 5
            bits_idx = (63 - bits_b - bits_lvl) // d
            spec = (bits_b, bits_lvl, min(bits_idx, 21))
            self._pack_spec = spec
        bits_b, bits_lvl, bits_idx = spec
        rows = np.asarray(rows, np.int64)
        # idx < 2^lvl, so lvl <= bits_idx guarantees idx fits; >=16
        # levels per base cell (65k^dim cells) is beyond any host forest
        if rows[:, 1].size and rows[:, 1].max(initial=0) > bits_idx:
            raise RuntimeError(
                f"forest level {int(rows[:, 1].max())} exceeds the "
                f"{bits_idx}-bit key budget")
        key = rows[:, 0]
        key = (key << bits_lvl) | rows[:, 1]
        for a in range(self.dim):
            key = (key << bits_idx) | rows[:, 2 + a]
        return key

    class _LeafTable:
        """Sorted-key membership/rank queries over the current leaf set."""

        def __init__(self, forest, b_arr, lvl, idx):
            rows = np.column_stack([b_arr, lvl, idx])
            packed = forest._pack_rows(rows)
            self._pack = forest._pack_rows
            self.perm = np.argsort(packed, kind="stable")
            self.sorted = packed[self.perm]
            self.n = len(packed)

        def find(self, rows: np.ndarray) -> np.ndarray:
            """[K, 2+d] -> element index in all_leaves order, or -1."""
            if len(rows) == 0:
                return np.zeros(0, np.int64)
            p = self._pack(np.asarray(rows, np.int64))
            pos = np.searchsorted(self.sorted, p)
            posc = np.minimum(pos, self.n - 1)
            ok = (pos < self.n) & (self.sorted[posc] == p)
            return np.where(ok, self.perm[posc], -1)

    def _neighbors_vec(self, b_arr, lvl, idx, face):
        """Same-level neighbors across `face` for ALL leaves at once
        (rotated/periodic base adjacency applied per base-cell group).

        Returns (nb_b, nb_idx, nb_face, perm [E,d], flip [E,d], valid);
        valid=False at true domain boundaries."""
        d = self.dim
        axis, side = divmod(face, 2)
        E = len(b_arr)
        n = np.int64(1) << lvl
        nb_b = b_arr.copy()
        nb_idx = idx.copy()
        nb_idx[:, axis] += 1 if side else -1
        nb_face = np.full(E, face ^ 1, np.int64)
        perm = np.tile(np.arange(d, dtype=np.int64), (E, 1))
        flip = np.zeros((E, d), bool)
        valid = np.ones(E, bool)
        crossing = (nb_idx[:, axis] < 0) | (nb_idx[:, axis] >= n)
        if crossing.any():
            for b in np.unique(b_arr[crossing]):
                sel = np.nonzero(crossing & (b_arr == b))[0]
                nbr = self._adjacency.get((int(b), face))
                if nbr is None:
                    valid[sel] = False
                    continue
                b2, f2, p, fl = nbr
                axis2, side2 = divmod(f2, 2)
                ns = n[sel]
                jd = np.zeros((len(sel), d), np.int64)
                for a in range(d):
                    if a == axis:
                        continue
                    jd[:, p[a]] = (ns - 1 - idx[sel, a]) if fl[a] \
                        else idx[sel, a]
                jd[:, axis2] = np.where(side2, ns - 1, 0)
                nb_b[sel] = b2
                nb_idx[sel] = jd
                nb_face[sel] = f2
                perm[sel] = np.asarray(p)
                flip[sel] = np.asarray(fl)
        return nb_b, nb_idx, nb_face, perm, flip, valid

    # ------------------------------------------------------------------
    @staticmethod
    def children(leaf: Leaf, dim: int):
        lvl = leaf[0]
        idx = leaf[1:]
        out = []
        for childbits in range(2 ** dim):
            ci = tuple(2 * idx[a] + ((childbits >> a) & 1)
                       for a in range(dim))
            out.append((lvl + 1,) + ci)
        return out

    @staticmethod
    def parent(leaf: Leaf, dim: int):
        lvl = leaf[0]
        if lvl == 0:
            return None
        return (lvl - 1,) + tuple(leaf[1 + a] // 2 for a in range(dim))

    # ------------------------------------------------------------------
    def _neighbor(self, b: int, leaf: Leaf, face: int):
        """Same-level neighbor across `face`, possibly in an adjacent
        (possibly rotated) base cell.  Returns
        (b', leaf', face', perm, flip) — face' is the neighbor's face at
        the interface and (perm, flip) the b->b' tangent transform — or
        None at a domain boundary."""
        d = self.dim
        lvl = leaf[0]
        n = 1 << lvl
        idx = list(leaf[1:])
        axis, side = divmod(face, 2)
        ident = tuple(range(d))
        noflip = (False,) * d
        idx[axis] += 1 if side else -1
        if 0 <= idx[axis] < n:
            return b, (lvl, *idx), face ^ 1, ident, noflip
        nb = self._adjacency.get((b, face))
        if nb is None:
            return None
        b2, f2, perm, flip = nb
        axis2, side2 = divmod(f2, 2)
        jd = [0] * d
        for a in range(d):
            if a == axis:
                continue
            a2 = perm[a]
            jd[a2] = (n - 1 - leaf[1 + a]) if flip[a] else leaf[1 + a]
        jd[axis2] = n - 1 if side2 else 0
        return b2, (lvl, *jd), f2, perm, flip

    def _exists(self, b: int, leaf: Leaf) -> str:
        """'leaf' | 'finer' | 'coarser' | 'none'."""
        if leaf in self.leaves[b]:
            return "leaf"
        anc = self.parent(leaf, self.dim)
        while anc is not None:
            if anc in self.leaves[b]:
                return "coarser"
            anc = self.parent(anc, self.dim)
        # otherwise it is covered by finer leaves (interior position)
        return "finer"

    # ------------------------------------------------------------------
    def refine(self, marked) -> None:
        """Subdivide every marked leaf.  ``marked`` is a list of
        (b, leaf) pairs or an int64 array of (b, lvl, idx...) rows (the
        bulk fast path: children built as one array, sets updated per
        base-cell group)."""
        d = self.dim
        if isinstance(marked, np.ndarray):
            if not len(marked):
                return
            rows = marked
            bits = np.arange(1 << d)
            off = np.stack([(bits >> a) & 1 for a in range(d)],
                           axis=1).astype(np.int64)      # [2^d, d]
            kid = np.repeat(rows, 1 << d, axis=0)
            kid[:, 1] += 1
            kid[:, 2:] = (kid[:, 2:] << 1) + np.tile(off, (len(rows), 1))
            order = np.argsort(rows[:, 0], kind="stable")
            rows_s = rows[order]
            kid_s = kid.reshape(len(rows), 1 << d, d + 2)[order]
            bounds = np.flatnonzero(np.diff(rows_s[:, 0])) + 1
            for pgrp, kgrp in zip(np.split(rows_s, bounds),
                                  np.split(kid_s, bounds)):
                b = int(pgrp[0, 0])
                s = self.leaves[b]
                ptup = list(map(tuple, pgrp[:, 1:].tolist()))
                ktup = list(map(tuple,
                                kgrp[:, :, 1:]
                                .reshape(-1, d + 1).tolist()))
                for i, leaf in enumerate(ptup):
                    if leaf in s:
                        s.remove(leaf)
                        s.update(ktup[i * (1 << d):(i + 1) * (1 << d)])
            self._invalidate()
            return
        child_off = [(1,) + tuple((bits >> a) & 1 for a in range(d))
                     for bits in range(2 ** d)]
        for b, leaf in marked:
            s = self.leaves[b]
            if leaf in s:
                s.remove(leaf)
                lvl = leaf[0]
                base2 = (lvl,) + tuple(2 * x for x in leaf[1:])
                s.update(tuple(x + o for x, o in zip(base2, off))
                         for off in child_off)
        if len(marked):
            self._invalidate()

    def coarsen(self, marked: list[tuple[int, Leaf]]) -> None:
        """Merge sibling groups when ALL siblings are marked leaves.

        Vectorized (the GMG hierarchy rebuild coarsens the ENTIRE forest
        once per level per adaptation): candidate parents are packed-key
        groups of the marked rows with a full 2^d distinct children.
        ``marked`` may also be an int64 array of (b, lvl, idx...) rows
        directly (the zero-python-loop internal fast path)."""
        d = self.dim
        if isinstance(marked, np.ndarray):
            rows = marked
        else:
            if not marked:
                return
            rows = np.array([(b,) + leaf for b, leaf in marked],
                            np.int64)
        rows = rows[rows[:, 1] > 0]
        if not len(rows):
            return
        # dedup marked rows, then group by parent cell
        rows = rows[np.unique(self._pack_rows(rows), return_index=True)[1]]
        par = rows.copy()
        par[:, 1] -= 1
        par[:, 2:] >>= 1
        pkey = self._pack_rows(par)
        order = np.argsort(pkey, kind="stable")
        _, starts, counts = np.unique(pkey[order], return_index=True,
                                      return_counts=True)
        full = counts == (1 << d)
        if not full.any():
            return
        sel = order[starts[full]]                # one marked child/group
        parents = par[sel]                       # [K, 1+d]
        # expand each parent to its 2^d children (all marked by
        # construction, hence all leaves: marked entries come from the
        # current leaf order)
        bits = np.arange(1 << d)
        off = np.stack([(bits >> a) & 1 for a in range(d)],
                       axis=1).astype(np.int64)            # [2^d, d]
        kid = np.repeat(parents, 1 << d, axis=0)
        kid[:, 1] += 1
        kid[:, 2:] = (kid[:, 2:] << 1) + np.tile(off, (len(parents), 1))
        # apply, grouped per base cell
        pb = parents[:, 0]
        border = np.argsort(pb, kind="stable")
        pb_s = parents[border]
        bounds = np.flatnonzero(np.diff(pb_s[:, 0])) + 1
        kid_by_parent = kid.reshape(len(parents), 1 << d, d + 2)
        kid_s = kid_by_parent[border]
        for pgrp, kgrp in zip(np.split(pb_s, bounds),
                              np.split(kid_s, bounds)):
            b = int(pgrp[0, 0])
            s = self.leaves[b]
            ptup = list(map(tuple, pgrp[:, 1:].tolist()))
            ktup = list(map(tuple,
                            kgrp[:, :, 1:].reshape(-1, d + 1).tolist()))
            # guard: only merge groups whose children are ALL currently
            # leaves (public-API safety; internal callers always satisfy
            # this)
            ok = [all(k in s for k in ktup[i * (1 << d):
                                           (i + 1) * (1 << d)])
                  for i in range(len(ptup))]
            for i, good in enumerate(ok):
                if good:
                    s.difference_update(
                        ktup[i * (1 << d):(i + 1) * (1 << d)])
                    s.add(ptup[i])
        self._invalidate()

    def _is_subdivided(self, b: int, cell: Leaf) -> bool:
        """True if `cell` is covered by strictly finer leaves."""
        if cell in self.leaves[b]:
            return False
        anc = self.parent(cell, self.dim)
        while anc is not None:
            if anc in self.leaves[b]:
                return False        # covered by a coarser leaf
            anc = self.parent(anc, self.dim)
        return True

    def _violates_2to1(self, b: int, leaf: Leaf, face: int) -> bool:
        """Neighbor across `face` subdivided at least twice toward us?"""
        nb = self._neighbor(b, leaf, face)
        if nb is None:
            return False
        b2, ncell, face2, _, _ = nb
        if not self._is_subdivided(b2, ncell):
            return False
        # ncell is subdivided once; a violation needs one of its children
        # TOUCHING the shared face (the neighbor's face2) to be
        # subdivided again
        axis2, side2 = divmod(face2, 2)
        want_bit = side2                  # neighbor child facing back at us
        for k, child in enumerate(self.children(ncell, self.dim)):
            if ((k >> axis2) & 1) == want_bit and \
                    self._is_subdivided(b2, child):
                return True
        return False

    def balance(self) -> None:
        """Enforce 2:1 level difference across faces (p4est-style).

        Single level-descending sweep (the p4est ripple argument): every
        leaf at level l requires its face-neighbor cells at level l-1 to
        exist or be finer; violations are fixed by subdividing the
        coarse covering leaf toward the required cell, which only
        creates leaves at levels < l — already-processed levels stay
        valid.  Neighbor generation and the satisfied-check are
        vectorized; only actual violations fall back to per-cell work.
        """
        d = self.dim
        while True:
            b_arr, lvl, idx = self._leaf_arrays_only()
            if len(b_arr) == 0:
                return
            table = self._LeafTable(self, b_arr, lvl, idx)
            max_lvl = int(lvl.max())
            fixed_any = False
            for cur in range(max_lvl, 1, -1):
                sel = np.nonzero(lvl == cur)[0]
                if len(sel) == 0:
                    continue
                req_rows = []
                for face in range(2 * d):
                    nb_b, nb_idx, _, _, _, valid = self._neighbors_vec(
                        b_arr[sel], lvl[sel], idx[sel], face)
                    ok = np.nonzero(valid)[0]
                    if len(ok) == 0:
                        continue
                    req_rows.append(np.column_stack(
                        [nb_b[ok], np.full(len(ok), cur - 1),
                         nb_idx[ok] // 2]))
                if not req_rows:
                    continue
                req = np.concatenate(req_rows)
                # packed-key dedup == unique(axis=0) lex order, minus
                # the void-dtype byte-compare sort
                _, first = np.unique(self._pack_rows(req),
                                     return_index=True)
                req = req[first]
                # satisfied unless a STRICT ancestor of the required
                # cell is a leaf; check ancestor levels vectorized
                violating = []          # (row, ancestor level found)
                pending = req
                for up in range(1, cur):
                    anc_lvl = cur - 1 - up
                    anc = pending.copy()
                    anc[:, 1] = anc_lvl
                    anc[:, 2:] = pending[:, 2:] >> up
                    hit = table.find(anc) >= 0
                    if hit.any():
                        violating.append(pending[hit])
                    pending = pending[~hit]
                    if len(pending) == 0:
                        break
                if not violating:
                    continue
                fixed_any = True
                for row in np.concatenate(violating):
                    b = int(row[0])
                    target = (int(row[1]),) + tuple(int(x)
                                                    for x in row[2:])
                    # subdivide the covering leaf down to the target
                    anc = target
                    while anc is not None and anc not in self.leaves[b]:
                        anc = self.parent(anc, d)
                    while anc is not None and anc[0] < target[0]:
                        self.leaves[b].remove(anc)
                        kids = self.children(anc, d)
                        self.leaves[b].update(kids)
                        shift = target[0] - (anc[0] + 1)
                        want = tuple(x >> shift for x in target[1:])
                        anc = next(k for k in kids if k[1:] == want)
            if not fixed_any:
                return
            self._invalidate()
            # re-sweep: subdividing for one face can (rarely) create a
            # fresh violation against an even coarser diagonal chain at
            # a level the sweep already passed on a DIFFERENT base cell
            # frame; the loop converges in <= max_level passes

    # ------------------------------------------------------------------
    def build_mesh(self):
        """Lower the forest to a Mesh + non-conforming face list.

        Returns (mesh, elem_of[(b, leaf)] dict, nc_faces list).
        Fully vectorized over leaves (node placement in ONE
        ``place_nodes`` call, neighbor status via sorted-key lookups) —
        the round-2 per-leaf loops were a wall at 10^6 leaves.
        """
        base, d = self.base, self.dim
        nc = 2 ** d
        order, b_arr, lvl, idx = self._leaf_arrays()
        elem_of = {key: i for i, key in enumerate(order)}
        E = len(order)

        # corner vertex coordinates per leaf via the base-cell mapping
        from .basis import _lex_indices
        corner_ij = _lex_indices(2, d).astype(np.float64)
        h = 1.0 / (np.int64(1) << lvl).astype(np.float64)   # [E]
        ref = (idx.astype(np.float64)[:, None, :]
               + corner_ij[None, :, :]) * h[:, None, None]  # [E, nc, d]
        verts = place_nodes(base, base.vertices[base.cells[b_arr]],
                            ref, elem_ids=b_arr)

        flat = verts.reshape(-1, d)
        tol = _mesh_tolerance(base.vertices, base.cells) / \
            (1 << int(lvl.max())) / 4
        from .mesh import _dedup_nodes
        vertices, inverse = _dedup_nodes(flat, tol)
        cells = inverse.reshape(E, nc)

        # boundary faces + non-conforming faces, vectorized per face
        table = self._LeafTable(self, b_arr, lvl, idx)
        bf_elem, bf_face, bf_bid = [], [], []
        ncf_cols = []           # (fine_elem, fine_face, coarse_elem,
        #                          coarse_face, perm, flip, childbits)
        n_arr = np.int64(1) << lvl
        # boundary id of (base cell, face), -1 when interior — one dense
        # lookup table instead of a per-base-cell python loop
        nb_cells = base.n_cells
        bid_of = np.full((nb_cells, 2 * d), -1, np.int64)
        if len(base.boundary_faces):
            bfa = np.asarray(base.boundary_faces, np.int64)
            bid_of[bfa[:, 0], bfa[:, 1]] = bfa[:, 2]
        for face in range(2 * d):
            axis, side = divmod(face, 2)
            at_bdry = idx[:, axis] == (n_arr - 1 if side else 0)
            # boundary ids are per BASE cell: map through the table
            if at_bdry.any():
                rows = np.nonzero(at_bdry)[0]
                bids = bid_of[b_arr[rows], face]
                sel = rows[bids >= 0]
                if len(sel):
                    bf_elem.append(sel)
                    bf_face.append(np.full(len(sel), face, np.int64))
                    bf_bid.append(bid_of[b_arr[sel], face])
            nb_b, nb_idx, nb_face, perm, flip, valid = \
                self._neighbors_vec(b_arr, lvl, idx, face)
            ok = np.nonzero(valid)[0]
            if len(ok) == 0:
                continue
            same = table.find(np.column_stack(
                [nb_b[ok], lvl[ok], nb_idx[ok]])) >= 0
            cand = ok[~same & (lvl[ok] > 0)]
            if len(cand) == 0:
                continue
            coarse = table.find(np.column_stack(
                [nb_b[cand], lvl[cand] - 1, nb_idx[cand] // 2]))
            # neighbors that are neither same-level, parent-level, nor
            # subdivided mean a >1-level jump: the forest is unbalanced
            deep = cand[coarse < 0]
            for up in range(2, int(lvl.max()) + 1):
                sub = deep[lvl[deep] >= up]
                if len(sub) == 0:
                    break
                anc_hit = table.find(np.column_stack(
                    [nb_b[sub], lvl[sub] - up,
                     nb_idx[sub] >> up])) >= 0
                if anc_hit.any():
                    raise RuntimeError("forest not 2:1 balanced")
            fine_side = cand[coarse >= 0]
            if len(fine_side) == 0:
                continue
            ce = coarse[coarse >= 0]
            # tmap data: per fine tangent axis, the coarse axis
            # perm[a], flip[a], and the neighbor's child bit along it
            childbits = nb_idx[fine_side] & 1          # [K, d]
            ncf_cols.append((fine_side,
                             np.full(len(fine_side), face, np.int64),
                             ce, nb_face[fine_side],
                             perm[fine_side], flip[fine_side],
                             childbits))

        if bf_elem:
            bf = np.column_stack([np.concatenate(bf_elem),
                                  np.concatenate(bf_face),
                                  np.concatenate(bf_bid)])
            # old per-leaf loop order: (elem, face)-major
            bf = bf[np.lexsort((bf[:, 1], bf[:, 0]))]
        else:
            bf = np.zeros((0, 3), np.int64)

        nc_faces: list[NonConformingFace] = []
        if ncf_cols:
            fe = np.concatenate([c[0] for c in ncf_cols])
            ff = np.concatenate([c[1] for c in ncf_cols])
            ce = np.concatenate([c[2] for c in ncf_cols])
            cf = np.concatenate([c[3] for c in ncf_cols])
            pm = np.concatenate([c[4] for c in ncf_cols])
            fl = np.concatenate([c[5] for c in ncf_cols])
            cb = np.concatenate([c[6] for c in ncf_cols])
            so = np.lexsort((ff, fe))
            fe, ff, ce, cf = fe[so], ff[so], ce[so], cf[so]
            pm, fl, cb = pm[so], fl[so], cb[so]
            # bulk-assemble the per-face tangent maps: for each fine
            # tangent axis a != ff//2 in ascending order, the triple
            # (perm[a], flip[a], childbit[perm[a]])
            K = len(fe)
            tang = np.argsort(
                np.arange(d)[None, :] == (ff[:, None] // 2),
                axis=1, kind="stable")[:, :d - 1]          # [K, d-1]
            pm_t = np.take_along_axis(pm, tang, axis=1)
            fl_t = np.take_along_axis(fl, tang, axis=1)
            cb_t = np.take_along_axis(cb, pm_t, axis=1)
            trip = np.empty((K, d - 1, 3), np.int64)
            trip[:, :, 0] = pm_t
            trip[:, :, 1] = fl_t
            trip[:, :, 2] = cb_t
            trip_l = trip.reshape(K, -1).tolist()
            fe_l, ff_l = fe.tolist(), ff.tolist()
            ce_l, cf_l = ce.tolist(), cf.tolist()
            if d == 2:
                nc_faces = [NonConformingFace(
                    coarse_elem=c, coarse_face=g, fine_elem=e,
                    fine_face=f, tmap=((t[0], bool(t[1]), t[2]),))
                    for e, f, c, g, t in zip(fe_l, ff_l, ce_l, cf_l,
                                             trip_l)]
            else:
                nc_faces = [NonConformingFace(
                    coarse_elem=c, coarse_face=g, fine_elem=e,
                    fine_face=f,
                    tmap=((t[0], bool(t[1]), t[2]),
                          (t[3], bool(t[4]), t[5])))
                    for e, f, c, g, t in zip(fe_l, ff_l, ce_l, cf_l,
                                             trip_l)]

        mesh = Mesh(dim=d, vertices=vertices, cells=cells,
                    boundary_faces=bf.reshape(-1, 3),
                    manifold_all=base.manifold_all,
                    boundary_manifolds=dict(base.boundary_manifolds),
                    periodic=list(base.periodic))
        return mesh, elem_of, nc_faces

    # ------------------------------------------------------------------
    def levels(self) -> dict:
        return {key: key[1][0] for key in
                ((b, leaf) for b, leaf in self.all_leaves())}
