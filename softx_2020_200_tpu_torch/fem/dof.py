"""DoF numbering and constraint metadata (DoFHandler/AffineConstraints
equivalent — SURVEY.md §2.5).

``FESpace`` elevates a corner mesh to a global Qk node set: per-cell
lattice nodes are placed manifold-aware, geometrically deduplicated into a
global numbering, periodic boundary pairs are fused topologically (so
periodicity needs no runtime constraint handling at all), and per-boundary
node/face index arrays are extracted for Dirichlet masks and boundary
integrals.

All arrays are NumPy on the host; the solver moves them to device once.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .basis import TensorBasis
from .mesh import Mesh, place_nodes, _dedup_nodes, _mesh_tolerance


@dataclass
class FESpace:
    mesh: Mesh
    degree: int
    basis: TensorBasis = None                 # type: ignore[assignment]
    nodes: np.ndarray = None                  # [N, dim] float64
    elem_nodes: np.ndarray = None             # [E, nn] int32
    # boundary_id -> unique node indices on that boundary
    boundary_nodes: dict[int, np.ndarray] = field(default_factory=dict)
    # boundary_id -> faces array [(elem, local_face)]
    boundary_faces: dict[int, np.ndarray] = field(default_factory=dict)

    def __post_init__(self):
        if self.basis is None:
            self.build()

    # ------------------------------------------------------------------
    def build(self) -> None:
        mesh, degree = self.mesh, self.degree
        dim = mesh.dim
        self.basis = TensorBasis(dim, degree)
        nn = self.basis.n_nodes

        corner_coords = mesh.vertices[mesh.cells]            # [E, 2^d, d]
        cell_nodes = place_nodes(mesh, corner_coords, self.basis.nodes)
        # physical per-element coordinates BEFORE any periodic fusion:
        # wrap elements must keep their true geometry (the fused master
        # node lives on the other side of the domain)
        self._cell_coords = cell_nodes
        tol = _mesh_tolerance(mesh.vertices, mesh.cells) / max(1, degree)
        flat = cell_nodes.reshape(-1, dim)
        nodes, inverse = _dedup_nodes(flat, tol)
        elem_nodes = inverse.reshape(mesh.n_cells, nn)

        # --- periodic fusion: remap slave-boundary nodes onto masters ----
        if mesh.periodic:
            remap = np.arange(nodes.shape[0])
            # decks declare BOTH directions of each pair (bc 0 -> 1 and
            # bc 1 -> 0); fusing both ways builds a 2-cycle in `remap`
            # whose chain resolution collapses to the identity — i.e. NO
            # fusion at all.  Process each unordered pair exactly once.
            seen = set()
            for (bid_a, bid_b, axis) in mesh.periodic:
                key = (min(bid_a, bid_b), max(bid_a, bid_b), axis)
                if key in seen:
                    continue
                seen.add(key)
                na = _boundary_node_set(mesh, self.basis, elem_nodes, bid_a)
                nb = _boundary_node_set(mesh, self.basis, elem_nodes, bid_b)
                if na.size == 0 or nb.size == 0:
                    continue
                # match nodes of b onto a by coordinates ignoring `axis`
                keep = [d for d in range(dim) if d != axis]
                ka = np.round(nodes[na][:, keep] / tol).astype(np.int64)
                kb = np.round(nodes[nb][:, keep] / tol).astype(np.int64)
                amap = {tuple(row): idx for row, idx in zip(ka, na)}
                bset = {tuple(row) for row in kb}
                unmatched = []
                for row, idx in zip(kb, nb):
                    master = amap.get(tuple(row))
                    if master is None:
                        unmatched.append(idx)
                        continue
                    remap[idx] = master
                if unmatched:
                    # a NON-CONFORMING (adapted) seam: the finer side
                    # has extra nodes, which hang — legitimate only when
                    # every master-side node does have a partner (the
                    # coarse lattice nests in the fine one); the extra
                    # nodes are constrained by the forest's hanging rows
                    if not all(tuple(row) in bset for row in ka):
                        idx = unmatched[0]
                        raise ValueError(
                            f"periodic boundaries {bid_a}/{bid_b}: no "
                            f"match for node at {nodes[idx]}")
            # resolve chained identifications (edge/corner nodes are
            # slaves of several periodic pairs: x-then-y-then-z)
            for _ in range(dim):
                remap = remap[remap]
            # compress numbering
            elem_nodes = remap[elem_nodes]
            used = np.unique(elem_nodes)
            new_id = -np.ones(nodes.shape[0], dtype=np.int64)
            new_id[used] = np.arange(used.size)
            elem_nodes = new_id[elem_nodes]
            nodes = nodes[used]

        self.nodes = nodes
        self.elem_nodes = elem_nodes.astype(np.int32)

        # --- per-boundary face + node sets -------------------------------
        self.boundary_faces = {}
        self.boundary_nodes = {}
        if mesh.boundary_faces.size:
            for bid in np.unique(mesh.boundary_faces[:, 2]):
                sel = mesh.boundary_faces[:, 2] == bid
                self.boundary_faces[int(bid)] = \
                    mesh.boundary_faces[sel][:, :2].astype(np.int32)
                nset = _boundary_node_set(mesh, self.basis,
                                          self.elem_nodes, int(bid))
                self.boundary_nodes[int(bid)] = nset

    # ------------------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_elements(self) -> int:
        return self.elem_nodes.shape[0]

    @property
    def dim(self) -> int:
        return self.mesh.dim

    def n_dofs(self, n_components: int) -> int:
        return self.n_nodes * n_components

    def element_coords(self) -> np.ndarray:
        """[E, nn, dim] physical coordinates of every element's nodes
        (pre-fusion: correct wrap-element geometry on periodic meshes)."""
        return self._cell_coords

    def all_boundary_nodes(self) -> np.ndarray:
        if not self.boundary_nodes:
            return np.zeros(0, dtype=np.int64)
        return np.unique(np.concatenate(list(self.boundary_nodes.values())))


def _boundary_node_set(mesh: Mesh, basis: TensorBasis,
                       elem_nodes: np.ndarray, bid: int) -> np.ndarray:
    """Unique global node ids lying on boundary `bid`."""
    out = []
    for (e, lf, b) in mesh.boundary_faces:
        if int(b) != bid:
            continue
        out.append(elem_nodes[int(e), basis.face_nodes(int(lf))])
    if not out:
        return np.zeros(0, dtype=np.int64)
    return np.unique(np.concatenate(out))
