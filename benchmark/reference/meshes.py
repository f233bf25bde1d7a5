"""The benchmarked decks' meshes, worked out again from the deck alone
(NumPy, float64): node coordinates, element connectivity, element node
coordinates and the nodes of each boundary id.

- ``subdivided_hyper_rectangle`` with periodic axes: a Q_k lattice whose
  periodic seams are wrapped (each element keeps its own, unwrapped
  coordinates).
- ``channel_with_cylinder``: the Schaefer-Turek channel as the solver's
  documentation describes its coarse mesh (a graded background grid with
  a four-cell O-ring around the cylinder), refined uniformly
  ``initial refinement`` times as a forest refines it: the fine cells'
  corners come from their coarse cell, and each fine cell's nodes from
  its own corners.  Each map is multilinear, plus, in a cell with a face
  on the cylinder, the transfinite correction of that face (a point's
  footprint on the face moved radially onto the circle through the
  face's corners, scaled by one minus its reference distance from the
  face).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree

from .fe import Element


@dataclass
class RefMesh:
    nodes: np.ndarray        # [N, d]
    elems: np.ndarray        # [E, nn] into nodes
    xe: np.ndarray           # [E, nn, d] element node coordinates
    boundary: dict           # boundary id -> node indices
    h_min: float             # smallest element edge, for tolerances


def box_lattice(n, p0, p1, degree: int, periodic) -> RefMesh:
    """Q_k lattice on the box p0..p1 with n[a] cells along axis a;
    ``periodic[a]`` wraps axis a.  Boundary ids 2a (low) and 2a + 1
    (high) on the non-periodic axes."""
    d = len(n)
    el = Element(d, degree)
    n = np.asarray(n)
    size = (np.asarray(p1, float) - np.asarray(p0, float)) / n
    counts = np.where(periodic, degree * n, degree * n + 1)
    # element origins, coordinate 0 fastest
    cells = np.stack(np.meshgrid(*[np.arange(m) for m in n],
                                 indexing="ij"), -1)
    cells = cells.transpose(tuple(range(d))[::-1] + (d,)).reshape(-1, d)
    local = np.rint(el.support * degree).astype(np.int64)    # [nn, d]
    gidx = cells[:, None, :] * degree + local[None]           # [E, nn, d]
    xe = np.asarray(p0, float) + gidx * (size / degree)
    gidx = np.where(periodic, gidx % counts, gidx)
    strides = np.cumprod(np.concatenate([[1], counts[:-1]]))
    elems = (gidx * strides).sum(-1)
    grid = np.stack(np.meshgrid(*[np.arange(c) for c in counts],
                                indexing="ij"), -1)
    grid = grid.transpose(tuple(range(d))[::-1] + (d,)).reshape(-1, d)
    nodes = np.asarray(p0, float) + grid * (size / degree)
    boundary = {}
    for a in range(d):
        if periodic[a]:
            continue
        boundary[2 * a] = np.where(grid[:, a] == 0)[0]
        boundary[2 * a + 1] = np.where(grid[:, a] == counts[a] - 1)[0]
    return RefMesh(nodes, elems, xe, boundary, float(size.min()))


def _cylinder_coarse(length, height, cx, cy, radius):
    """Coarse cells [C, 4, 2] (corners lexicographic) and the local face
    of each ring cell on the cylinder (face 0: its first axis, low)."""
    s = 2.0 * radius
    xs = sorted({0.0, cx - s, cx + s}
                | set(np.linspace(cx + s, length, 7)[1:]))
    ys = sorted({0.0, cy - s, cy + s, height})
    cells = []
    for i in range(len(xs) - 1):
        for j in range(len(ys) - 1):
            if abs(xs[i] - (cx - s)) < 1e-12 and abs(ys[j] - (cy - s)) < 1e-12:
                continue
            cells.append([(xs[i], ys[j]), (xs[i + 1], ys[j]),
                          (xs[i], ys[j + 1]), (xs[i + 1], ys[j + 1])])
    on_cylinder = []
    ring = [(225, 315), (315, 45), (45, 135), (135, 225)]

    def circ(a):
        return (cx + radius * math.cos(math.radians(a)),
                cy + radius * math.sin(math.radians(a)))

    def square(a):
        return {225: (cx - s, cy - s), 315: (cx + s, cy - s),
                45: (cx + s, cy + s), 135: (cx - s, cy + s)}[a]

    for a, b in ring:
        on_cylinder.append(len(cells))
        cells.append([circ(a), square(a), circ(b), square(b)])
    return np.asarray(cells, float), on_cylinder


def channel_with_cylinder(args: str, refinement: int, degree: int) -> RefMesh:
    """The deck's ``grid arguments`` "L, H : cx, cy : R", refined
    ``refinement`` times, Q_k nodes.  Boundary ids: 0 inlet, 1 outlet,
    2 walls, 3 cylinder."""
    parts = [[float(v) for v in p.split(",")] for p in args.split(":")]
    (length, height), (cx, cy), (radius,) = parts
    centre = np.array([cx, cy])
    coarse, ring = _cylinder_coarse(length, height, cx, cy, radius)
    el = Element(2, degree)
    m = 2 ** refinement
    sub = np.stack(np.meshgrid(np.arange(m), np.arange(m), indexing="ij"),
                   -1).transpose(1, 0, 2).reshape(-1, 2)     # x fastest
    corner_ref = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], float)
    ref = (sub[:, None, :] + corner_ref[None]) / m             # [S, 4, 2]
    # the fine cells' corners: the coarse cell's map, corrected on the
    # cylinder face
    corners = _place(coarse, ref, ring, centre)                # [C, S, 4, 2]
    # their nodes: each fine cell's own map, corrected on its own face
    # on the cylinder (the fine cells of the ring's first column)
    C, S = corners.shape[:2]
    flat = corners.reshape(C * S, 4, 2)
    on_face = [c * S + k for c in ring for k in np.nonzero(sub[:, 0] == 0)[0]]
    xe = _place(flat, np.broadcast_to(el.support, (C * S,) + el.support.shape),
                on_face, centre, per_cell=True)
    h_min = float(min(np.linalg.norm(flat[:, a] - flat[:, b], axis=-1).min()
                      for a, b in ((0, 1), (0, 2), (1, 3), (2, 3))))
    nodes, elems = _merge(xe, 1e-6 * h_min / degree)
    tol = 1e-9 * max(length, height)
    x, y = nodes[:, 0], nodes[:, 1]
    r = np.linalg.norm(nodes - centre, axis=1)
    boundary = {0: np.where(np.abs(x) < tol)[0],
                1: np.where(np.abs(x - length) < tol)[0],
                2: np.where((np.abs(y) < tol) | (np.abs(y - height) < tol))[0],
                3: np.where(np.abs(r - radius) < tol)[0]}
    return RefMesh(nodes, elems, xe, boundary, h_min / degree)


def _place(cells: np.ndarray, ref: np.ndarray, curved, centre,
           per_cell: bool = False) -> np.ndarray:
    """Points of reference coordinates ``ref`` ([P, n, 2] shared, or
    [C, n, 2] one set per cell with ``per_cell``) in the cells [C, 4, 2]:
    the multilinear map, plus, in the cells listed in ``curved``, the
    transfinite correction of their face 0 (first axis low) onto the
    circle about ``centre`` through its corners."""
    el = Element(2, 1)
    w = el.corner_weights(ref)
    spec = "cnk,ckd->cnd" if per_cell else "pnk,ckd->cpnd"
    out = np.einsum(spec, w, cells)
    for c in curved:
        r = ref[c] if per_cell else ref
        foot_ref = r.copy()
        foot_ref[..., 0] = 0.0
        foot = np.einsum("...k,kd->...d", el.corner_weights(foot_ref),
                         cells[c])
        rel = foot - centre
        rad = np.linalg.norm(rel, axis=-1, keepdims=True)
        r_target = np.mean(np.linalg.norm(cells[c][[0, 2]] - centre,
                                          axis=-1))
        delta = centre + rel / rad * r_target - foot
        out[c] = out[c] + (1.0 - r[..., :1]) * delta
    return out


def _merge(xe: np.ndarray, tol: float):
    """Unique nodes of element node coordinates [E, nn, d] (points closer
    than ``tol`` are one node) and the connectivity into them."""
    pts = xe.reshape(-1, xe.shape[-1])
    pairs = cKDTree(pts).query_pairs(tol, output_type="ndarray")
    n = len(pts)
    graph = coo_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])),
                       shape=(n, n))
    _, label = connected_components(graph, directed=False)
    _, first, inverse = np.unique(label, return_index=True,
                                  return_inverse=True)
    return pts[first], inverse.reshape(xe.shape[:2])


def from_deck(deck: dict, dim: int) -> RefMesh:
    """The mesh of a deck (the subset of the deck's options the
    benchmarked configurations use)."""
    mesh = deck["mesh"]
    degree = int(deck["FEM"]["velocity order"])
    if int(deck["FEM"].get("pressure order", degree)) != degree:
        raise ValueError("the reference takes equal orders")
    grid, args = mesh["grid type"], mesh["grid arguments"]
    refinement = int(mesh.get("initial refinement", "0"))
    if grid == "subdivided_hyper_rectangle":
        parts = [p.strip() for p in args.split(":")]
        n = [int(v) * 2 ** refinement for v in parts[0].split(",")]
        p0 = [float(v) for v in parts[1].split(",")]
        p1 = [float(v) for v in parts[2].split(",")]
        periodic = [False] * dim
        for bc in _bcs(deck):
            if bc["type"] == "periodic":
                periodic[int(bc["periodic_direction"])] = True
        return box_lattice(n, p0, p1, degree, periodic)
    if grid == "channel_with_cylinder":
        return channel_with_cylinder(args, refinement, degree)
    raise ValueError(f"the reference has no mesh {grid!r}")


def _bcs(deck: dict):
    bcs = deck.get("boundary conditions", {})
    return [v for k, v in bcs.items() if k.startswith("bc ")]
