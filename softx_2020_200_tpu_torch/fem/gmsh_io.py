"""Gmsh .msh reader (GridIn::read_msh equivalent — SURVEY.md §2.2
``read_mesh``).

Supports MSH 2.2 and MSH 4.x ASCII: quad4/hex8 first-order cells and
quad9/hex27 SECOND-ORDER (curved) cells — the curved geometry lands in
``Mesh.geom_nodes`` and is honored by ``place_nodes`` (isoparametric
when the FE degree is >= 2, the reference's MappingQ behavior).
Codimension-1 elements carry their physical tag (4.x: the entity's
physical group, falling back to the entity tag) as the boundary id.
Gmsh corner ordering is converted to this framework's lexicographic
ordering; higher-order node ordering is resolved GEOMETRICALLY (nearest
multilinear lattice position), which is robust across gmsh's hex27
node-numbering conventions.
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh

# gmsh element type -> (n_nodes, dim, order)
_TYPES = {1: (2, 1, 1), 3: (4, 2, 1), 5: (8, 3, 1), 15: (1, 0, 1),
          8: (3, 1, 2), 10: (9, 2, 2), 12: (27, 3, 2)}
_SERENDIPITY = {16: "quad8", 17: "hex20", 9: "line3(6-node tri)"}

# gmsh corner order -> lexicographic order
_QUAD_TO_LEX = [0, 1, 3, 2]
_HEX_TO_LEX = [0, 1, 3, 2, 4, 5, 7, 6]


def _lattice_perm(verts_xyz: np.ndarray, dim: int) -> np.ndarray:
    """Permutation p with geom_lex[k] = verts[p[k]] for one second-order
    cell: match each of the 3^dim gmsh nodes to its nearest multilinear
    lattice position (gmsh always lists the 2^dim corners first)."""
    from .basis import _lex_indices
    nc = 2 ** dim
    corner_order = _QUAD_TO_LEX if dim == 2 else _HEX_TO_LEX
    corners_lex = verts_xyz[corner_order]              # [nc, d] lex order
    lat = _lex_indices(3, dim).astype(np.float64) / 2  # [3^dim, d]
    w = np.ones((lat.shape[0], nc))
    for c in range(nc):
        for d in range(dim):
            bit = (c >> d) & 1
            w[:, c] *= lat[:, d] if bit else (1.0 - lat[:, d])
    predicted = w @ corners_lex                        # [3^dim, d]
    dist = np.linalg.norm(predicted[:, None, :] - verts_xyz[None, :, :],
                          axis=-1)
    # optimal assignment (strong curvature makes plain nearest-match
    # collide — e.g. a single cell spanning a 90-degree arc)
    try:
        from scipy.optimize import linear_sum_assignment
        rows, cols = linear_sum_assignment(dist)
        perm = np.empty(dist.shape[0], dtype=np.int64)
        perm[rows] = cols
    except ImportError:
        perm = np.full(dist.shape[0], -1, dtype=np.int64)
        used = np.zeros(dist.shape[1], dtype=bool)
        for k, j in sorted(((k, j) for k in range(dist.shape[0])
                            for j in range(dist.shape[1])),
                           key=lambda kj: dist[kj]):
            if perm[k] < 0 and not used[j]:
                perm[k] = j
                used[j] = True
    if len(set(perm.tolist())) != perm.shape[0]:
        raise ValueError("gmsh: could not resolve second-order node "
                         "ordering (cell too distorted)")
    # the corner rows must agree with gmsh's documented corner order —
    # a mismatch means the cell is inverted or wildly distorted
    corner_rows = np.nonzero((_lex_indices(3, dim) % 2 == 0)
                             .all(axis=1))[0]
    expect = np.asarray(corner_order)
    if not np.array_equal(perm[corner_rows], expect):
        raise ValueError("gmsh: second-order corner ordering mismatch")
    return perm


def _build_mesh(coords, raw_cells, face_sets, dim):
    """Common assembly from parsed (corner cells | second-order cells)."""
    cells = []
    geom_rows = []
    any_curved = any(order == 2 for _, order in raw_cells)
    for verts, order in raw_cells:
        if order == 1:
            lex = _QUAD_TO_LEX if dim == 2 else _HEX_TO_LEX
            cells.append([verts[j] for j in lex])
            geom_rows.append(None)
        else:
            vx = coords[verts]                          # [3^dim, d]
            perm = _lattice_perm(vx, dim)
            lat_ids = [verts[j] for j in perm]          # lex 3^dim ids
            # corners of the Q2 lattice (lex): stride-2 positions
            from .basis import _lex_indices
            ij = _lex_indices(3, dim)
            corner_sel = np.nonzero((ij % 2 == 0).all(axis=1))[0]
            cells.append([lat_ids[j] for j in corner_sel])
            geom_rows.append(coords[lat_ids])

    cells = np.asarray(cells, dtype=np.int64)
    if cells.size == 0:
        raise ValueError("gmsh file contains no cells of the mesh dim")

    geom = None
    if any_curved:
        # mixed meshes: synthesize straight-cell lattices multilinearly
        from .basis import _lex_indices
        lat = _lex_indices(3, dim).astype(np.float64) / 2
        nc = 2 ** dim
        w = np.ones((lat.shape[0], nc))
        for c in range(nc):
            for d in range(dim):
                bit = (c >> d) & 1
                w[:, c] *= lat[:, d] if bit else (1.0 - lat[:, d])
        geom = np.zeros((cells.shape[0], 3 ** dim, dim))
        for e, row in enumerate(geom_rows):
            geom[e] = row if row is not None else w @ coords[cells[e]]

    # attach boundary faces to cells (corner-vertex matching)
    from .basis import _lex_indices
    corner_ij = _lex_indices(2, dim)
    nc = 2 ** dim
    face_lookup = dict(face_sets)
    bfaces = []
    for e in range(cells.shape[0]):
        for f in range(2 * dim):
            axis, side = divmod(f, 2)
            sel = [c for c in range(nc)
                   if corner_ij[c, axis] == (1 if side else 0)]
            key = tuple(sorted(int(cells[e, c]) for c in sel))
            if key in face_lookup:
                bfaces.append((e, f, face_lookup[key]))
    return Mesh(dim=dim, vertices=coords, cells=cells,
                boundary_faces=np.asarray(bfaces,
                                          dtype=np.int64).reshape(-1, 3),
                geom_nodes=geom)


def _face_corners(verts, edim, order):
    """Corner vertex ids of a codim-1 element (drop high-order nodes)."""
    if order == 1:
        return verts
    if edim == 1:                       # line3: corners first
        return verts[:2]
    return verts[:4]                    # quad9: corners first


def read_msh(path: str, dim: int) -> Mesh:
    with open(path) as fh:
        lines = [ln.strip() for ln in fh]
    version = None
    for j, ln in enumerate(lines):
        if ln == "$MeshFormat":
            version = lines[j + 1].split()[0]
            break
    if version is None:
        raise ValueError("gmsh: missing $MeshFormat")
    if version.startswith("2"):
        return _read_msh2(lines, dim)
    if version.startswith("4"):
        return _read_msh4(lines, dim)
    raise ValueError(f"gmsh format {version} unsupported")


def _check_type(etype):
    if etype in _SERENDIPITY:
        raise ValueError(
            f"gmsh element type {etype} ({_SERENDIPITY[etype]}) "
            "unsupported — export with full second order "
            "(Mesh.SecondOrderIncomplete = 0)")
    if etype not in _TYPES:
        raise ValueError(f"gmsh element type {etype} unsupported "
                         "(first/second-order quad/hex meshes only)")
    return _TYPES[etype]


def _read_msh2(lines, dim: int) -> Mesh:
    i = 0

    def seek(tag):
        nonlocal i
        while i < len(lines) and lines[i] != tag:
            i += 1
        if i >= len(lines):
            raise ValueError(f"gmsh: missing {tag}")
        i += 1

    seek("$Nodes")
    n_nodes = int(lines[i]); i += 1
    id_map = {}
    coords = np.zeros((n_nodes, dim))
    for k in range(n_nodes):
        parts = lines[i + k].split()
        id_map[int(parts[0])] = k
        coords[k] = [float(x) for x in parts[1:1 + dim]]
    i += n_nodes
    seek("$Elements")
    n_elem = int(lines[i]); i += 1

    raw_cells = []
    face_sets: list[tuple[tuple, int]] = []
    for k in range(n_elem):
        parts = lines[i + k].split()
        etype = int(parts[1])
        nn, edim, order = _check_type(etype)
        ntags = int(parts[2])
        phys = int(parts[3]) if ntags >= 1 else 0
        verts = [id_map[int(v)] for v in parts[3 + ntags:]]
        if edim == dim:
            raw_cells.append((verts, order))
        elif edim == dim - 1:
            fc = _face_corners(verts, edim, order)
            face_sets.append((tuple(sorted(fc)), phys))
    return _build_mesh(coords, raw_cells, face_sets, dim)


def _read_msh4(lines, dim: int) -> Mesh:
    i = 0

    def seek(tag):
        nonlocal i
        while i < len(lines) and lines[i] != tag:
            i += 1
        if i >= len(lines):
            raise ValueError(f"gmsh: missing {tag}")
        i += 1

    # entity -> boundary id: physical group when present, entity tag
    # otherwise (deal.II's read_msh convention)
    ent_phys: dict[tuple[int, int], int] = {}
    j = 0
    while j < len(lines) and lines[j] != "$Entities":
        j += 1
    if j < len(lines):
        j += 1
        np_, nc_, ns_, nv_ = (int(x) for x in lines[j].split()[:4])
        j += 1
        for edim, count, skip in ((0, np_, 4), (1, nc_, 7),
                                  (2, ns_, 7), (3, nv_, 7)):
            for _ in range(count):
                parts = lines[j].split()
                tag = int(parts[0])
                nphys = int(parts[skip])
                phys = int(parts[skip + 1]) if nphys >= 1 else tag
                ent_phys[(edim, tag)] = phys
                j += 1

    seek("$Nodes")
    hdr = lines[i].split(); i += 1
    n_blocks, n_nodes = int(hdr[0]), int(hdr[1])
    id_map = {}
    coords = np.zeros((n_nodes, dim))
    row = 0
    for _ in range(n_blocks):
        bdim, btag, par, nb = (int(x) for x in lines[i].split()); i += 1
        tags = [int(lines[i + t]) for t in range(nb)]
        i += nb
        for t in range(nb):
            parts = lines[i + t].split()
            id_map[tags[t]] = row
            coords[row] = [float(x) for x in parts[:dim]]
            row += 1
        i += nb

    seek("$Elements")
    hdr = lines[i].split(); i += 1
    n_blocks = int(hdr[0])
    raw_cells = []
    face_sets: list[tuple[tuple, int]] = []
    for _ in range(n_blocks):
        bdim, btag, etype, nb = (int(x) for x in lines[i].split())
        i += 1
        if bdim in (dim, dim - 1):
            nn, edim, order = _check_type(etype)
            phys = ent_phys.get((bdim, btag), btag)
            for t in range(nb):
                parts = lines[i + t].split()
                verts = [id_map[int(v)] for v in parts[1:1 + nn]]
                if edim == dim:
                    raw_cells.append((verts, order))
                else:
                    fc = _face_corners(verts, edim, order)
                    face_sets.append((tuple(sorted(fc)), phys))
        i += nb
    return _build_mesh(coords, raw_cells, face_sets, dim)
