"""Mesh generation and representation.

Replaces the reference's use of deal.II ``GridGenerator`` / ``GridIn`` +
``Manifold`` (SURVEY.md §2.1 'Manifolds', §2.2 ``read_mesh``).  Meshes are
plain arrays: corner vertices + cell connectivity in lexicographic corner
order (coordinate 0 fastest — identical to the tensor-product basis node
ordering), plus tagged boundary faces.  Generators accept deal.II-style
``grid type`` / ``grid arguments`` strings so reference decks work
unmodified.

Everything here is host-side NumPy; device arrays are built by
:mod:`.dof` / the solver layer.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Manifold:
    """A curved-geometry description (deal.II SphericalManifold analogue)."""
    type: str                    # 'spherical'
    center: np.ndarray           # [dim]


@dataclass
class Mesh:
    dim: int
    vertices: np.ndarray          # [Nv, dim] float64
    cells: np.ndarray             # [E, 2^dim] int64, lexicographic corners
    # boundary faces: columns (elem, local_face, boundary_id)
    boundary_faces: np.ndarray    # [F, 3] int64
    # manifold applying to the whole mesh (polar/spherical structured blocks)
    manifold_all: Manifold | None = None
    # boundary_id -> Manifold for boundary-attached curved geometry
    boundary_manifolds: dict[int, Manifold] = field(default_factory=dict)
    # declared periodic identifications: (bid_a, bid_b, axis)
    periodic: list[tuple[int, int, int]] = field(default_factory=list)
    # element-lattice dims when the mesh is a logically-Cartesian block
    # (enables the structured fast path in ops/structured.py)
    structured_shape: tuple | None = None
    # per-cell quadratic geometry lattice [E, 3^dim, dim] (lexicographic)
    # for curved second-order gmsh cells; None = straight-edged /
    # manifold-described geometry
    geom_nodes: np.ndarray | None = None

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def n_vertices(self) -> int:
        return self.vertices.shape[0]

    # ------------------------------------------------------------------
    def refine_uniform(self, times: int = 1) -> "Mesh":
        mesh = self
        for _ in range(times):
            mesh = _refine_once(mesh)
        return mesh


# --------------------------------------------------------------------------
# node placement (manifold-aware) — shared by refinement and Qk elevation
# --------------------------------------------------------------------------

def _to_polar(pts: np.ndarray, center: np.ndarray) -> np.ndarray:
    """Cartesian -> (r, theta[, z-polar]) coordinates. 2D: (r, theta).
    3D spherical: (r, theta, phi)."""
    rel = pts - center
    if pts.shape[-1] == 2:
        r = np.hypot(rel[..., 0], rel[..., 1])
        th = np.arctan2(rel[..., 1], rel[..., 0])
        return np.stack([r, th], axis=-1)
    r = np.linalg.norm(rel, axis=-1)
    th = np.arctan2(rel[..., 1], rel[..., 0])
    phi = np.arccos(np.clip(rel[..., 2] / np.maximum(r, 1e-300), -1, 1))
    return np.stack([r, th, phi], axis=-1)


def _from_polar(pol: np.ndarray, center: np.ndarray) -> np.ndarray:
    if pol.shape[-1] == 2:
        r, th = pol[..., 0], pol[..., 1]
        return center + np.stack([r * np.cos(th), r * np.sin(th)], axis=-1)
    r, th, phi = pol[..., 0], pol[..., 1], pol[..., 2]
    return center + np.stack([
        r * np.sin(phi) * np.cos(th),
        r * np.sin(phi) * np.sin(th),
        r * np.cos(phi)], axis=-1)


def _multilinear_weights(ref: np.ndarray, nc: int, dim: int) -> np.ndarray:
    """Corner shape functions at reference points.

    ref [..., nn, dim] -> w [..., nn, nc], corner c bit d = (c >> d) & 1.
    Built by outer products over axes (2 + 4 + ... array passes instead
    of the nc*dim in-place multiply sweep — this runs on every leaf of
    the forest at every adaptation)."""
    f = [np.stack([1.0 - ref[..., d], ref[..., d]], axis=-1)
         for d in range(dim)]
    w = f[dim - 1]
    for d in range(dim - 2, -1, -1):
        w = (w[..., :, None] * f[d][..., None, :])
        w = w.reshape(w.shape[:-2] + (-1,))
    return w


def place_nodes(mesh: Mesh, corner_coords: np.ndarray,
                ref_nodes: np.ndarray, elem_ids=None) -> np.ndarray:
    """Map reference nodes into every cell, honoring manifolds.

    ``elem_ids`` maps rows of ``corner_coords`` to the mesh's element
    indices when only a subset of cells is passed (forest path: leaves
    carry their BASE cell's index; several rows may share one id);
    default is the identity.

    corner_coords: [E, 2^dim, dim] cell corner positions.
    ref_nodes:     [nn, dim] shared reference coordinates in [0,1]^dim,
                   or [E, nn, dim] PER-ELEMENT coordinates (the
                   vectorized forest path: every leaf is a different
                   sub-window of its base cell).
    Returns [E, nn, dim] physical node positions.

    With no manifold: multilinear (Q1) interpolation of the corners.
    With a mesh-wide spherical manifold (polar-structured shells): the
    interpolation runs in polar coordinates about the center, which places
    edge/face/interior nodes exactly on circular arcs — the behavior the
    reference gets from SphericalManifold on a hyper_shell.
    """
    E, nc, dim = corner_coords.shape
    per_elem = ref_nodes.ndim == 3
    nn = ref_nodes.shape[-2]
    # corner shape functions: [nn, nc] shared or [E, nn, nc] per element
    w = _multilinear_weights(ref_nodes, nc, dim)
    wm = "enc" if per_elem else "nc"

    if mesh.manifold_all is not None and mesh.manifold_all.type == "spherical":
        center = mesh.manifold_all.center
        pol = _to_polar(corner_coords, center)       # [E, nc, dim]
        # unwrap theta per cell around the first corner
        th0 = pol[:, :1, 1]
        dth = pol[:, :, 1] - th0
        dth = (dth + np.pi) % (2 * np.pi) - np.pi
        pol = pol.copy()
        pol[:, :, 1] = th0 + dth
        nodes_pol = np.einsum(f"{wm},ecd->end", w, pol)
        return _from_polar(nodes_pol, center)

    if mesh.geom_nodes is not None:
        # curved second-order cells (gmsh quad9/hex27): map through the
        # per-cell quadratic geometry lattice instead of the corners.
        # Isoparametric accuracy needs FE degree >= 2 downstream (the
        # reference's MappingQ/'qmapping all' behavior).
        from .basis import TensorBasis
        geom = (mesh.geom_nodes if elem_ids is None
                else mesh.geom_nodes[np.asarray(elem_ids)])
        tb = TensorBasis(dim, 2)
        if per_elem:
            B2, _, _ = tb.tabulate(ref_nodes.reshape(-1, dim))
            B2 = B2.reshape(E, nn, -1)
            return np.einsum("enk,ekd->end", B2, geom)
        B2, _, _ = tb.tabulate(ref_nodes)
        return np.einsum("nk,ekd->end", B2, geom)

    nodes = np.einsum(f"{wm},ecd->end", w, corner_coords)

    # boundary-attached spherical manifolds: TRANSFINITE blending of the
    # curved-face correction into the cell interior (deal.II's
    # TransfiniteInterpolationManifold behavior).  Projecting ONLY the
    # on-face nodes leaves interior nodes on the straight chord; on the
    # forest path (leaf sub-lattices placed directly from the BASE
    # cell), leaves thinner than the chord sag then INVERT.  Instead:
    # every node takes the correction of its face FOOTPRINT (multilinear
    # image with the face-normal reference coordinate pinned to the
    # face), scaled by (1 - distance from the face in reference
    # coordinates).  On the face this reduces to the radial projection;
    # at the opposite face the correction vanishes, so neighboring
    # cells/base-cells stay crack-free.
    if mesh.boundary_manifolds:
        if elem_ids is None:
            e_order = e_sorted = None
        else:
            # one base cell may own MANY batch rows (vectorized forest
            # path); sorted-key group slices instead of a per-row
            # python dict build
            eids = np.asarray(elem_ids)
            e_order = np.argsort(eids, kind="stable")
            e_sorted = eids[e_order]
        for (e, lf, bid) in mesh.boundary_faces:
            man = mesh.boundary_manifolds.get(int(bid))
            if man is None or man.type != "spherical":
                continue
            if e_order is None:
                rows = np.asarray([int(e)])
            else:
                lo = np.searchsorted(e_sorted, int(e))
                hi = np.searchsorted(e_sorted, int(e), side="right")
                rows = e_order[lo:hi]
            if not len(rows):
                continue
            axis, side = divmod(int(lf), 2)
            target = 1.0 if side else 0.0
            ref_r = (ref_nodes[rows] if per_elem
                     else np.broadcast_to(
                         ref_nodes, (len(rows), nn, dim))).copy()
            ref_r[..., axis] = target
            wf = _multilinear_weights(ref_r, nc, dim)   # [R, nn, nc]
            cc_r = corner_coords[rows]                  # [R, nc, d]
            foot = np.einsum("rnc,rcd->rnd", wf, cc_r)
            rel = foot - man.center
            rad = np.linalg.norm(rel, axis=-1, keepdims=True)
            c_sel = [c for c in range(nc) if ((c >> axis) & 1) == side]
            r_target = np.mean(np.linalg.norm(
                cc_r[:, c_sel] - man.center, axis=-1),
                axis=1)                                 # [R]
            delta = man.center + rel / np.maximum(rad, 1e-300) \
                * r_target[:, None, None] - foot
            ref_ax = (ref_nodes[rows][..., axis] if per_elem
                      else np.broadcast_to(ref_nodes[:, axis],
                                           (len(rows), nn)))
            blend = 1.0 - np.abs(ref_ax - target)
            nodes[rows] = nodes[rows] + blend[..., None] * delta
    return nodes


def _dedup_nodes(all_nodes: np.ndarray, tol: float):
    """Merge geometrically coincident nodes.

    all_nodes: [M, dim]. Returns (unique_nodes[N, dim], inverse[M]).
    Node ids follow the lexicographic coordinate order (the structured
    fast path relies on this).  Uses the native meshkit dedup when
    available (same ordering), NumPy otherwise.
    """
    x = all_nodes / tol
    q = np.round(x).astype(np.int64)
    from ..native import dedup_rows
    native = dedup_rows(q)
    if native is not None:
        first, inverse = native
    else:
        _, first, inverse = np.unique(q, axis=0, return_index=True,
                                      return_inverse=True)

    # bin-straddle guard: two coincident-intent nodes (inexact gmsh
    # floats) can land in ADJACENT quantization bins when they sit within
    # float noise of a bin boundary, silently cracking the mesh.  Detect
    # the (rare) risky inputs and union their bins with any neighboring
    # bin whose representative lies closer than tol.
    frac = x - q
    risky = np.nonzero(np.any(np.abs(frac) > 0.49, axis=1))[0]
    if risky.size:
        uq = q[first]
        lookup = {tuple(r): i for i, r in enumerate(uq)}
        parent = np.arange(len(first))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        import itertools
        offs = [o for o in itertools.product((-1, 0, 1),
                                             repeat=all_nodes.shape[1])
                if any(o)]
        for i in risky:
            a = find(inverse[i])
            for off in offs:
                j = lookup.get(tuple(q[i] + np.asarray(off)))
                if j is None:
                    continue
                b = find(j)
                if a == b:
                    continue
                if np.linalg.norm(all_nodes[i] - all_nodes[first[b]]) < tol:
                    # keep the lexicographically-smaller bin so the
                    # surviving unique rows stay in sorted order
                    lo, hi = (a, b) if a < b else (b, a)
                    parent[hi] = lo
                    a = lo
        roots = np.array([find(i) for i in range(len(first))])
        if np.any(roots != np.arange(len(first))):
            keep = np.nonzero(roots == np.arange(len(first)))[0]
            remap = np.full(len(first), -1, dtype=np.int64)
            remap[keep] = np.arange(len(keep))
            inverse = remap[roots[inverse]]
            first = first[keep]
    return all_nodes[first], inverse


def _mesh_tolerance(vertices: np.ndarray, cells: np.ndarray) -> float:
    v0 = vertices[cells[:, 0]]
    v1 = vertices[cells[:, 1]]
    h = np.linalg.norm(v1 - v0, axis=-1)
    hmin = max(h.min(), 1e-12)
    return hmin * 1e-6


# --------------------------------------------------------------------------
# uniform refinement
# --------------------------------------------------------------------------

def _refine_once(mesh: Mesh) -> Mesh:
    dim = mesh.dim
    nc = 2 ** dim
    # generate 3^dim nodes per cell (degree-2 lattice), manifold-aware
    n1d = 3
    from .basis import _lex_indices
    ij = _lex_indices(n1d, dim)                       # [3^dim, dim]
    ref = ij.astype(np.float64) / 2.0
    corner_coords = mesh.vertices[mesh.cells]         # [E, 2^dim, dim]
    cell_nodes = place_nodes(mesh, corner_coords, ref)  # [E, 3^dim, dim]

    tol = _mesh_tolerance(mesh.vertices, mesh.cells)
    flat = cell_nodes.reshape(-1, dim)
    new_vertices, inverse = _dedup_nodes(flat, tol)
    gid = inverse.reshape(mesh.n_cells, n1d ** dim)   # [E, 3^dim]

    # children: offsets in {0,1}^dim; child corner (b0..bd) at lattice
    # index (o+b) per axis
    E = mesh.n_cells
    children = np.zeros((E, nc, nc), dtype=np.int64)
    child_of = {}
    for ci in range(nc):
        off = [(ci >> d) & 1 for d in range(dim)]
        for corner in range(nc):
            lat = 0
            stride = 1
            for d in range(dim):
                bit = (corner >> d) & 1
                lat += (off[d] + bit) * stride
                stride *= n1d
            children[:, ci, corner] = gid[:, lat]
        child_of[tuple(off)] = ci
    new_cells = children.reshape(E * nc, nc)

    # boundary faces: child cells with matching offset on the face axis
    faces = []
    for (e, lf, bid) in mesh.boundary_faces:
        axis, side = divmod(int(lf), 2)
        for ci in range(nc):
            off = [(ci >> d) & 1 for d in range(dim)]
            if off[axis] == side:
                faces.append((int(e) * nc + ci, int(lf), int(bid)))
    new_faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)

    new_geom = None
    if mesh.geom_nodes is not None:
        # children inherit the parent's quadratic map: evaluate it on
        # each child's own Q2 lattice (child ci spans [off, off+1]/2)
        from .basis import TensorBasis
        tb = TensorBasis(dim, 2)
        Ws = []
        for ci in range(nc):
            off = np.array([(ci >> d) & 1 for d in range(dim)],
                           dtype=np.float64)
            ref_child = (off[None, :] + tb.nodes) / 2.0
            B2, _, _ = tb.tabulate(ref_child)          # [3^dim, 3^dim]
            Ws.append(B2)
        W = np.stack(Ws)                               # [nc, nn2, nn2]
        child_geom = np.einsum("cnk,ekd->ecnd", W, mesh.geom_nodes)
        new_geom = child_geom.reshape(E * nc, n1d ** dim, dim)

    return Mesh(dim=dim, vertices=new_vertices, cells=new_cells,
                boundary_faces=new_faces, manifold_all=mesh.manifold_all,
                boundary_manifolds=dict(mesh.boundary_manifolds),
                periodic=list(mesh.periodic), geom_nodes=new_geom)


# --------------------------------------------------------------------------
# generators (GridGenerator equivalents)
# --------------------------------------------------------------------------

def subdivided_hyper_rectangle(p0, p1, subdivisions, colorize: bool = True,
                               dim: int | None = None) -> Mesh:
    """Axis-aligned box split into n0 x n1 (x n2) cells.

    Boundary ids follow the deal.II 'colorize' convention the reference
    decks rely on: 2*axis + side (x-: 0, x+: 1, y-: 2, y+: 3, z-: 4, z+: 5).
    Without colorize all boundary ids are 0.
    """
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    dim = dim or p0.shape[0]
    subs = np.asarray(subdivisions, dtype=np.int64)
    if subs.ndim == 0:
        subs = np.full(dim, int(subs))

    axes = [np.linspace(p0[d], p1[d], subs[d] + 1) for d in range(dim)]
    shape = [len(a) for a in axes]
    # vertices in lexicographic order, axis 0 fastest
    grids = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([g.reshape(-1, order="F") for g in grids], axis=-1)

    def vid(idx):
        n = 0
        stride = 1
        for d in range(dim):
            n += idx[d] * stride
            stride *= shape[d]
        return n

    cells = []
    E_idx = {}
    ranges = [range(subs[d]) for d in range(dim)]
    import itertools
    for en, cell_idx in enumerate(itertools.product(*reversed(ranges))):
        cell_idx = tuple(reversed(cell_idx))  # axis0 fastest enumeration
        corners = []
        for c in range(2 ** dim):
            idx = [cell_idx[d] + ((c >> d) & 1) for d in range(dim)]
            corners.append(vid(idx))
        cells.append(corners)
        E_idx[cell_idx] = en
    cells = np.asarray(cells, dtype=np.int64)

    faces = []
    for cell_idx, en in E_idx.items():
        for d in range(dim):
            if cell_idx[d] == 0:
                faces.append((en, 2 * d, 2 * d if colorize else 0))
            if cell_idx[d] == subs[d] - 1:
                faces.append((en, 2 * d + 1, 2 * d + 1 if colorize else 0))
    return Mesh(dim=dim, vertices=pts, cells=cells,
                boundary_faces=np.asarray(faces, dtype=np.int64).reshape(-1, 3),
                structured_shape=tuple(int(s) for s in subs))


def hyper_cube(left: float = 0.0, right: float = 1.0, colorize: bool = False,
               dim: int = 2) -> Mesh:
    return subdivided_hyper_rectangle([left] * dim, [right] * dim,
                                      [1] * dim, colorize=colorize, dim=dim)


def _cube_face_frames():
    """For each of the 6 cube faces: (outward normal, d1, d2) with
    det[n, d1, d2] = +1 so every O-grid block keeps a positive Jacobian
    (axis0 = radial outward, axes 1/2 tangential)."""
    frames = []
    for f in range(6):
        a, side = divmod(f, 2)
        n = np.zeros(3)
        n[a] = 2 * side - 1.0
        u, v = [ax for ax in range(3) if ax != a]
        d1 = np.zeros(3)
        d2 = np.zeros(3)
        d1[u], d2[v] = 1.0, 1.0
        if np.linalg.det(np.stack([n, d1, d2])) < 0:
            d1, d2 = d2, d1
        frames.append((n, d1, d2))
    return frames


def _ball_ogrid_cells(node, center, r_inner, outer_pt):
    """Six hex blocks between a sphere of radius ``r_inner`` and an outer
    surface described by ``outer_pt(q) -> point`` (q = the cube-corner
    direction vector of unit half-width).  Corner order is lexicographic
    with axis0 = radial; returns list of (cell_corners, sphere_is_face0).
    ``node`` is the shared vertex-dedup closure."""
    cells = []
    for (n, d1, d2) in _cube_face_frames():
        lex = [0] * 8                  # corner index = b0 + 2*b1 + 4*b2
        for b2 in (0, 1):
            for b1 in (0, 1):
                q = n + (2 * b1 - 1) * d1 + (2 * b2 - 1) * d2
                sp = center + r_inner * q / np.linalg.norm(q)
                lex[0 + 2 * b1 + 4 * b2] = node(*sp)
                lex[1 + 2 * b1 + 4 * b2] = node(*outer_pt(q))
        cells.append(lex)
    return cells


def hyper_shell(center, inner_radius: float, outer_radius: float,
                n_cells: int = 0, colorize: bool = True) -> Mesh:
    """Annulus (2D) / spherical shell (3D, 6-cell cube-sphere).

    Boundary ids (colorize, deal.II convention): inner = 0, outer = 1.
    2D: polar-structured with a mesh-wide spherical manifold (theta
    closed by shared vertices).  3D: six hex blocks between the two
    radii; both boundaries carry spherical manifolds, refinement places
    nodes on the true spheres via transfinite blending.
    """
    center = np.asarray(center, dtype=np.float64)
    dim = center.shape[0]
    if dim == 3:
        vid = {}
        verts = []

        def node(x, y, z):
            key = (round(x, 12), round(y, 12), round(z, 12))
            if key not in vid:
                vid[key] = len(verts)
                verts.append([x, y, z])
            return vid[key]

        def outer_pt(q):
            return center + outer_radius * q / np.linalg.norm(q)

        cells = _ball_ogrid_cells(node, center, inner_radius, outer_pt)
        faces = []
        for en in range(6):
            faces.append((en, 0, 0 if colorize else 0))   # inner sphere
            faces.append((en, 1, 1 if colorize else 0))   # outer sphere
        mesh = Mesh(dim=3, vertices=np.asarray(verts, dtype=np.float64),
                    cells=np.asarray(cells, dtype=np.int64),
                    boundary_faces=np.asarray(
                        faces, dtype=np.int64).reshape(-1, 3))
        man = Manifold("spherical", center)
        mesh.boundary_manifolds[0] = man
        mesh.boundary_manifolds[1] = man
        return mesh
    if n_cells <= 0:
        n_cells = 8
    nr, nth = 1, n_cells
    radii = np.linspace(inner_radius, outer_radius, nr + 1)
    thetas = np.linspace(0.0, 2 * np.pi, nth, endpoint=False)

    verts = np.zeros(((nr + 1) * nth, 2))
    for i, r in enumerate(radii):
        for j, th in enumerate(thetas):
            verts[i * nth + j] = center + r * np.array([np.cos(th), np.sin(th)])

    cells = []
    faces = []
    for i in range(nr):
        for j in range(nth):
            jn = (j + 1) % nth
            # lexicographic corners with axis0 = radial, axis1 = theta
            c00 = i * nth + j
            c10 = (i + 1) * nth + j
            c01 = i * nth + jn
            c11 = (i + 1) * nth + jn
            en = len(cells)
            cells.append([c00, c10, c01, c11])
            if i == 0:
                faces.append((en, 0, 0 if colorize else 0))
            if i == nr - 1:
                faces.append((en, 1, 1 if colorize else 0))
    return Mesh(dim=2, vertices=verts, cells=np.asarray(cells, dtype=np.int64),
                boundary_faces=np.asarray(faces, dtype=np.int64).reshape(-1, 3),
                manifold_all=Manifold("spherical", center))


def channel_with_cylinder(length: float = 2.2, height: float = 0.41,
                          cx: float = 0.2, cy: float = 0.2,
                          radius: float = 0.05) -> Mesh:
    """Rectangular channel with a circular hole (the Schaefer-Turek 2D
    cylinder benchmark geometry; reference decks use a gmsh mesh of the
    same topology).

    Multiblock coarse mesh: a 4-cell O-ring between the cylinder circle
    and the square [cx-2R, cx+2R] x [cy-2R, cy+2R], glued conformingly
    into a graded background grid.  The cylinder surface carries a
    spherical boundary manifold so refinement lands on the true circle.

    Boundary ids: 0 = inlet (x-), 1 = outlet (x+), 2 = walls (y-, y+),
    3 = cylinder surface.
    """
    s = 2.0 * radius                     # half-width of the ring square
    xs = sorted({0.0, cx - s, cx + s} |
                set(np.linspace(cx + s, length, 7)[1:]))
    ys = sorted({0.0, cy - s, cy + s, height})
    vid = {}
    verts = []

    def node(x, y):
        key = (round(x, 12), round(y, 12))
        if key not in vid:
            vid[key] = len(verts)
            verts.append([x, y])
        return vid[key]

    cells = []
    faces = []
    hole = (cx - s, cy - s)
    for i in range(len(xs) - 1):
        for j in range(len(ys) - 1):
            if (abs(xs[i] - hole[0]) < 1e-12 and
                    abs(ys[j] - hole[1]) < 1e-12):
                continue                  # the ring fills this cell
            c00 = node(xs[i], ys[j])
            c10 = node(xs[i + 1], ys[j])
            c01 = node(xs[i], ys[j + 1])
            c11 = node(xs[i + 1], ys[j + 1])
            en = len(cells)
            cells.append([c00, c10, c01, c11])
            if i == 0:
                faces.append((en, 0, 0))                 # inlet
            if i == len(xs) - 2:
                faces.append((en, 1, 1))                 # outlet
            if j == 0:
                faces.append((en, 2, 2))                 # bottom wall
            if j == len(ys) - 2:
                faces.append((en, 3, 2))                 # top wall

    # O-ring: circle nodes at the diagonal angles, square corners reused
    import math as _m
    angs = {225: _m.radians(225), 315: _m.radians(315),
            45: _m.radians(45), 135: _m.radians(135)}
    cnode = {k: node(cx + radius * _m.cos(a), cy + radius * _m.sin(a))
             for k, a in angs.items()}
    snode = {225: node(cx - s, cy - s), 315: node(cx + s, cy - s),
             45: node(cx + s, cy + s), 135: node(cx - s, cy + s)}
    # lexicographic corners [r0t0, r1t0, r0t1, r1t1]: axis0 = radial out,
    # axis1 = tangential ccw (positive orientation, like hyper_shell);
    # face 0 (axis0-) = cylinder surface
    ring = [(225, 315), (315, 45), (45, 135), (135, 225)]
    for a, b in ring:
        en = len(cells)
        cells.append([cnode[a], snode[a], cnode[b], snode[b]])
        faces.append((en, 0, 3))
    mesh = Mesh(dim=2, vertices=np.asarray(verts, dtype=np.float64),
                cells=np.asarray(cells, dtype=np.int64),
                boundary_faces=np.asarray(faces,
                                          dtype=np.int64).reshape(-1, 3))
    mesh.boundary_manifolds[3] = Manifold("spherical", np.array([cx, cy]))
    return mesh


def channel_with_sphere(length: float = 20.0, half_height: float = 5.0,
                        cx: float = 5.0, cy: float = 0.0, cz: float = 0.0,
                        radius: float = 0.5) -> Mesh:
    """Box channel with a spherical hole — the 3D analogue of
    :func:`channel_with_cylinder` and the geometry of BASELINE config #5
    (flow past a sphere, SURVEY.md §6).

    Multiblock coarse mesh: a 6-hex O-grid between the sphere surface
    and the cube [c - 2R, c + 2R]^3, glued conformingly into a graded
    background grid over [0, L] x [-H, H] x [-H, H].  The sphere surface
    carries a spherical boundary manifold so refinement lands on the
    true sphere (transfinite blending in :func:`place_nodes`).

    Boundary ids: 0 = inlet (x-), 1 = outlet (x+), 2 = lateral walls
    (y+-, z+-), 3 = sphere surface.
    """
    s = 2.0 * radius
    center = np.array([cx, cy, cz])
    n_wake = max(3, int(round((length - (cx + s)) / (2.5 * s))))
    xs = sorted({0.0, cx - s, cx + s}
                | set(np.linspace(cx + s, length, n_wake + 1)[1:])
                | (set(np.linspace(0.0, cx - s, 3)[1:-1])
                   if cx - s > 1.5 * s else set()))
    ys = sorted({-half_height, cy - s, cy + s, half_height}
                | ({-(half_height + s) / 2, (half_height + s) / 2}
                   if half_height > 3 * s else set()))
    zs = sorted({-half_height, cz - s, cz + s, half_height}
                | ({-(half_height + s) / 2, (half_height + s) / 2}
                   if half_height > 3 * s else set()))
    vid = {}
    verts = []

    def node(x, y, z):
        key = (round(x, 12), round(y, 12), round(z, 12))
        if key not in vid:
            vid[key] = len(verts)
            verts.append([x, y, z])
        return vid[key]

    cells = []
    faces = []
    hole = (cx - s, cy - s, cz - s)
    for i in range(len(xs) - 1):
        for j in range(len(ys) - 1):
            for k in range(len(zs) - 1):
                if (abs(xs[i] - hole[0]) < 1e-12
                        and abs(ys[j] - hole[1]) < 1e-12
                        and abs(zs[k] - hole[2]) < 1e-12):
                    continue              # the O-grid fills this cell
                c = [node(xs[i + b0], ys[j + b1], zs[k + b2])
                     for b2 in (0, 1) for b1 in (0, 1) for b0 in (0, 1)]
                en = len(cells)
                cells.append(c)
                if i == 0:
                    faces.append((en, 0, 0))                  # inlet
                if i == len(xs) - 2:
                    faces.append((en, 1, 1))                  # outlet
                if j == 0:
                    faces.append((en, 2, 2))
                if j == len(ys) - 2:
                    faces.append((en, 3, 2))
                if k == 0:
                    faces.append((en, 4, 2))
                if k == len(zs) - 2:
                    faces.append((en, 5, 2))

    def outer_pt(q):
        return center + s * q

    for lex in _ball_ogrid_cells(node, center, radius, outer_pt):
        en = len(cells)
        cells.append(lex)
        faces.append((en, 0, 3))          # sphere surface (axis0-)
    mesh = Mesh(dim=3, vertices=np.asarray(verts, dtype=np.float64),
                cells=np.asarray(cells, dtype=np.int64),
                boundary_faces=np.asarray(faces,
                                          dtype=np.int64).reshape(-1, 3))
    mesh.boundary_manifolds[3] = Manifold("spherical", center)
    return mesh


# --------------------------------------------------------------------------
# deal.II-style string dispatch ("grid type" / "grid arguments")
# --------------------------------------------------------------------------

def generate_mesh(grid_type: str, grid_arguments: str, dim: int,
                  initial_refinement: int = 0) -> Mesh:
    """Build a mesh from deck strings (reference ``read_mesh`` analogue)."""
    args = [a.strip() for a in grid_arguments.split(":")]

    def _floats(s):
        return [float(x) for x in s.replace(",", " ").split()]

    def _ints(s):
        return [int(float(x)) for x in s.replace(",", " ").split()]

    def _bool(s):
        return s.strip().lower() in ("true", "1", "yes", "on")

    gt = grid_type.strip().lower()
    if gt == "hyper_cube":
        left, right = (float(args[0]), float(args[1])) if len(args) >= 2 \
            else (0.0, 1.0)
        colorize = _bool(args[2]) if len(args) >= 3 else False
        # structured blocks refine by regeneration (keeps the lattice
        # metadata and the fast path alive)
        subs = 2 ** initial_refinement
        mesh = subdivided_hyper_rectangle([left] * dim, [right] * dim,
                                          [subs] * dim, colorize, dim=dim)
        initial_refinement = 0
    elif gt == "subdivided_hyper_rectangle":
        subs = _ints(args[0])
        p0 = _floats(args[1])
        p1 = _floats(args[2])
        colorize = _bool(args[3]) if len(args) >= 4 else False
        subs = [s * 2 ** initial_refinement for s in subs]
        initial_refinement = 0
        mesh = subdivided_hyper_rectangle(p0, p1, subs, colorize, dim=dim)
    elif gt == "hyper_shell":
        center = _floats(args[0])
        r_in, r_out = float(args[1]), float(args[2])
        n_cells = int(float(args[3])) if len(args) >= 4 else 0
        colorize = _bool(args[4]) if len(args) >= 5 else True
        mesh = hyper_shell(center, r_in, r_out, n_cells, colorize)
    elif gt == "channel_with_cylinder":
        # "length, height : cx, cy : radius"
        if len(args) >= 3:
            lh = _floats(args[0])
            cc = _floats(args[1])
            mesh = channel_with_cylinder(lh[0], lh[1], cc[0], cc[1],
                                         float(args[2]))
        else:
            mesh = channel_with_cylinder()
    elif gt == "channel_with_sphere":
        # "length, half_height : cx, cy, cz : radius"
        if len(args) >= 3:
            lh = _floats(args[0])
            cc = _floats(args[1])
            mesh = channel_with_sphere(lh[0], lh[1], cc[0], cc[1],
                                       cc[2], float(args[2]))
        else:
            mesh = channel_with_sphere()
    else:
        raise ValueError(f"unknown grid type {grid_type!r}")
    if initial_refinement > 0:
        mesh = mesh.refine_uniform(initial_refinement)
    return mesh
