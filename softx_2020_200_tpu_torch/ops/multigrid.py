"""Geometric multigrid preconditioner (counterpart of
``softx_2020_200_tpu.ops.multigrid``).

A cycle over a hierarchy of levels, built one of two ways:

- a structured lattice halves (after a Q1 level on the same lattice for
  degree > 1); the Newton state is injected, and every level runs the
  lattice kernel;
- a mesh in a forest (a Kelly-adapted leaf set, a multiblock or gmsh
  base mesh) coarsens through the forest: the same Q1 p-level first,
  then one forest level coarser at a time (every complete sibling family
  merged, then rebalanced).  Transfers are FE interpolation through
  base-cell reference coordinates, the Newton state is interpolated
  (nodes are not nested under bisection), and each level carries its own
  hanging-node constraints: its matvec is hc^T A hc, prolongation first
  fills its constrained rows from their masters, restriction moves the
  residual off them.  Every level runs the element kernel.

    smoother   : damped node-block Jacobi, or a few node-block-
                 preconditioned GMRES steps
    transfers  : FE interpolation (fine nodes evaluated in coarse cells,
                 host-precomputed masters/weights); restriction is its
                 transpose, a gather-sum
    coarse ops : each level is a ``GLSOperator`` linearized at the
                 restricted state
    bottom     : GMRES(coarse_iters) preconditioned by block-Jacobi
                 (the outer Krylov is then FGMRES)

Applying a cycle reads nothing back from the device: its inner GMRES
runs a fixed number of steps (``ops/linalg.py::gmres_fixed``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from ..core.spans import count, span, take, track_state
from ..fem.dof import FESpace
from ..fem.mesh import subdivided_hyper_rectangle
from .linalg import gmres_fixed
from .operators import assemble, build_assembly_map
from .preconditioners import apply_node_block_state, node_blocks_to_state

# the JAX package's cycle defaults, which every deck uses: one damped
# Jacobi sweep per smooth (weight 0.7), a K-cycle of 2 FGMRES steps, the
# w/k wrap on the first coarse level only, at most 10 levels
N_SMOOTH, OMEGA, CYCLE_M, CYCLE_LEVELS, MAX_LEVELS = 1, 0.7, 2, 1, 10

# the cycle's span names (``core/spans.py``) at each level k; level k's
# restrict and prolong move its residual to level k + 1 and the
# correction back
SPANS = [{part: f"gmg.L{k}.{part}" for part in
          ("smooth", "residual", "restrict", "prolong", "bottom")}
         for k in range(MAX_LEVELS)]


def _transfer_maps(fine_space, coarse_space):
    """Host precompute: interpolation masters/weights + injection."""
    cs, fs = coarse_space, fine_space
    ne = cs.mesh.structured_shape
    # domain bounds from the MESH vertices: on periodic axes the fused
    # node array stops one layer short of the domain end
    lo = cs.mesh.vertices.min(axis=0)
    hi = cs.mesh.vertices.max(axis=0)
    span = hi - lo
    pos = (fs.nodes - lo) / span
    e_idx = np.minimum((pos * np.asarray(ne)).astype(np.int64),
                       np.asarray(ne) - 1)
    cent = cs.element_coords().mean(axis=1)
    cent_idx = ((cent - lo) / span * np.asarray(ne)).astype(np.int64)
    lookup = {tuple(ci): e for e, ci in enumerate(cent_idx)}
    elem = np.array([lookup[tuple(ix)] for ix in e_idx], dtype=np.int64)
    corner0 = cs.element_coords()[elem][:, 0, :]
    h_elem = span / np.asarray(ne)
    ref = np.clip((fs.nodes - corner0) / h_elem, 0.0, 1.0)
    B = cs.basis.tabulate_values(ref)                  # [Nf, nn_c]
    masters = cs.elem_nodes[elem]
    scale = np.maximum(np.abs(fs.nodes).max(axis=0), 1.0)
    q_f = np.round(fs.nodes / scale * 1e10).astype(np.int64)
    q_c = np.round(cs.nodes / scale * 1e10).astype(np.int64)
    fmap = {tuple(r): i for i, r in enumerate(q_f)}
    inject = np.array([fmap[tuple(r)] for r in q_c], dtype=np.int64)
    return masters.astype(np.int32), B, inject.astype(np.int32)


@dataclass
class Level:
    """One level: its operator (a ``GLSOperator``, or in the GD
    hierarchy a ``GDVelocityLevel``), Dirichlet mask (hanging rows
    included) and hanging-node constraints ``hc`` (None or empty where
    the level is conforming), and (below the finest) the transfers from
    the level above: ``masters``/``weights`` [N_above, nn] interpolate
    this level's nodes to the level above; the Newton state comes down
    by ``inject`` [N] (this level's nodes picked out of the level above,
    on a lattice) or by interpolation through ``inj_masters``/
    ``inj_weights`` [N, nn_above] (on a forest).  ``restrict_idx`` [N, M]
    (made here) lists, for each node of this level, the slots of
    ``masters`` that name it: restriction is a gather and a sum over
    them, in a fixed order on every device.  ``part`` names the counter
    that counts this level's transfers besides ``transfer``
    (``core/spans.py::PARTS``), or None."""
    op: object
    mask: torch.Tensor
    masters: torch.Tensor | None = None
    weights: torch.Tensor | None = None
    inject: torch.Tensor | None = None
    restrict_idx: torch.Tensor | None = None
    inj_masters: torch.Tensor | None = None
    inj_weights: torch.Tensor | None = None
    hc: object = None
    part: str | None = None

    def __post_init__(self):
        if self.masters is not None and self.restrict_idx is None:
            amap = build_assembly_map(self.masters.cpu().numpy(),
                                      self.mask.shape[0])
            self.restrict_idx = amap.idx.to(self.masters.device)

    def down(self, x):
        """A nodal state of the level above -> this level (injection or
        interpolation)."""
        if self.inject is not None:
            return take("transfer", x, self.inject, self.part)
        return torch.einsum("nm,nmc->nc", self.inj_weights,
                            take("transfer", x, self.inj_masters, self.part))

    def hc_distribute(self, u):
        return u if self.hc is None else self.hc.distribute(u)

    def hc_transpose(self, R):
        return R if self.hc is None else self.hc.distribute_transpose(R)


def prolong(level: Level, vc):
    """This level's nodal field -> the level above, by interpolation
    (its constrained rows, which the cycle keeps at zero, filled from
    their masters first)."""
    vc = level.hc_distribute(vc)
    return torch.einsum("fm,fmc->fc", level.weights,
                        take("transfer", vc, level.masters, level.part))


def restrict(level: Level, rf):
    """A residual on the level above -> this level (the transpose of
    ``prolong``), as a gather-sum: no atomics, so the cycle adds in the
    same order on every run."""
    return level.hc_transpose(assemble(
        level.weights[:, :, None] * rf[:, None, :], level.restrict_idx,
        "transfer", level.part))


def _coarsen_forest(forest):
    """One-level-coarser forest: merge every complete sibling family,
    then re-balance (levels never exceed the input's anywhere)."""
    from ..fem.forest import Forest
    new = Forest.__new__(Forest)
    new.base = forest.base
    new.dim = forest.dim
    new.leaves = [set(s) for s in forest.leaves]
    new._adjacency = forest._adjacency
    b_arr, lvl, idx = forest._leaf_arrays_only()
    new.coarsen(np.column_stack([b_arr, lvl, idx]))
    new.balance()
    return new


def forest_transfers(fine_space, fine_forest, fine_elem_of, coarse_space,
                     coarse_forest, coarse_elem_of, device, dtype) -> dict:
    """The transfers between two spaces on nested forests (or one forest
    and two degrees), through base-cell reference coordinates: every fine
    node located in the coarse forest (``masters``/``weights``, the
    prolongation) and every coarse node in the fine forest
    (``inj_masters``/``inj_weights``, the state's interpolation)."""
    from ..fem.transfer import _new_node_base_positions, locate_in_forest
    d = fine_space.dim
    bc_f, bp_f = _new_node_base_positions(fine_space, fine_forest,
                                          fine_elem_of)
    elem_c, ref_c = locate_in_forest(bc_f, bp_f, coarse_forest,
                                     coarse_elem_of, d)
    bc_c, bp_c = _new_node_base_positions(coarse_space, coarse_forest,
                                          coarse_elem_of)
    elem_f, ref_f = locate_in_forest(bc_c, bp_c, fine_forest, fine_elem_of,
                                     d)
    kw = dict(dtype=dtype, device=device)

    def idx(a):
        return torch.as_tensor(a.astype(np.int64), device=device)

    return dict(
        masters=idx(coarse_space.elem_nodes[elem_c]),
        weights=torch.as_tensor(
            coarse_space.basis.tabulate_values(ref_c), **kw),
        inj_masters=idx(fine_space.elem_nodes[elem_f]),
        inj_weights=torch.as_tensor(
            fine_space.basis.tabulate_values(ref_f), **kw))


def hanging_level(space, nc_faces, bcs, device, dtype):
    """(Dirichlet mask [N, d+1] with the hanging rows set, hanging
    constraints) of a forest level on ``space``; the GD hierarchy keeps
    the mask's velocity columns."""
    from ..fem.constraints import build_hanging_constraints
    from ..solvers.boundary import BoundaryHandler
    hc = build_hanging_constraints(space, nc_faces).to(device, dtype)
    mask = BoundaryHandler(space, bcs, dtype=dtype, device=device).mask
    if hc.n:
        mask = mask.clone()
        mask[hc.ids] = True
    return mask, hc


def build_forest_hierarchy(solver, min_elems: int = 64) -> list[Level]:
    """Levels through the solver's forest, finest first: the Q1 p-level
    on the same forest mesh for degree > 1, then one forest level coarser
    at a time while the level has more than ``min_elems`` cells and the
    forest still coarsens (at most ``MAX_LEVELS``), each with its own
    hanging constraints (see the module's note)."""
    from ..solvers.gls import GLSOperator
    kw = dict(dtype=solver.dtype, device=solver.device)
    space, bcs = solver.space, solver.prm.boundary_conditions
    d = space.dim
    mask0 = solver.bh.mask
    if solver.hc.n:
        mask0 = mask0.clone()
        mask0[solver.hc.ids] = True
    levels = [Level(op=solver.op, mask=mask0, hc=solver.hc)]
    cur_forest, cur_space, cur_elem_of = (solver.forest, space,
                                          solver._elem_of)

    def add_level(cspace, n_q1d, nc_faces, forest, elem_of):
        # the coarse levels store the Jacobian state as the fine one does
        cop = GLSOperator(cspace, solver.op.nu, n_q1d=n_q1d,
                          stab=solver.op.stab,
                          state_dtype=solver.op.state_dtype, **kw)
        mask, hc = hanging_level(cspace, nc_faces, bcs, **kw)
        levels.append(Level(op=cop, mask=mask, hc=hc, **forest_transfers(
            cur_space, cur_forest, cur_elem_of, cspace, forest, elem_of,
            **kw)))

    if space.degree > 1:
        # p-coarsening first: a Q1 level on the SAME forest mesh
        cspace = FESpace(space.mesh, 1)
        add_level(cspace, 2, solver._nc_faces, cur_forest, cur_elem_of)
        cur_space = cspace
    while len(levels) < MAX_LEVELS and cur_space.n_elements > min_elems:
        cforest = _coarsen_forest(cur_forest)
        if cforest.n_leaves() >= cur_forest.n_leaves():
            break
        cmesh, c_elem_of, c_ncf = cforest.build_mesh()
        # the deck's periodic seams live on the fine mesh
        cmesh.periodic = list(space.mesh.periodic)
        cspace = FESpace(cmesh, cur_space.degree)
        add_level(cspace, int(round(solver.op.n_q ** (1 / d))), c_ncf,
                  cforest, c_elem_of)
        cur_forest, cur_space, cur_elem_of = cforest, cspace, c_elem_of
    return levels


def build_hierarchy(solver, min_elems: int = 256) -> list[Level]:
    """The level list for a GLS solver, finest first.

    A structured lattice coarsens in degree first (a Q1 level on the
    same lattice for degree > 1), then by halving the lattice while
    every axis is even and the coarse lattice keeps ``min_elems`` cells.
    Any other mesh coarsens through the solver's forest when it has one
    (``build_forest_hierarchy``); without one it gets only its own level,
    and the solver then uses block-Jacobi."""
    from ..solvers.boundary import BoundaryHandler
    from ..solvers.gls import GLSOperator
    space = solver.space
    kw = dict(dtype=solver.dtype, device=solver.device)
    levels = [Level(op=solver.op, mask=solver.bh.mask)]
    mesh = space.mesh
    if mesh.structured_shape is None:
        if solver.forest is not None:
            return build_forest_hierarchy(solver)
        return levels
    ne = tuple(mesh.structured_shape)
    lo = mesh.vertices.min(axis=0)
    hi = mesh.vertices.max(axis=0)
    prev_space = space

    def add_level(cspace, n_q1d, part=None):
        # the coarse levels store the Jacobian state as the fine one does
        cop = GLSOperator(cspace, solver.op.nu, n_q1d=n_q1d,
                          stab=solver.op.stab,
                          state_dtype=solver.op.state_dtype, **kw)
        cbh = BoundaryHandler(cspace, solver.prm.boundary_conditions, **kw)
        masters, weights, inject = _transfer_maps(prev_space, cspace)
        levels.append(Level(
            op=cop, mask=cbh.mask,
            masters=torch.as_tensor(masters.astype(np.int64),
                                    device=solver.device),
            weights=torch.as_tensor(weights, **kw),
            inject=torch.as_tensor(inject.astype(np.int64),
                                   device=solver.device), part=part))

    cur_degree = space.degree
    if space.degree > 1:
        # p-coarsening first: a Q1 level on the SAME lattice, then
        # h-halving at degree 1
        cspace = FESpace(mesh, 1)
        add_level(cspace, 2, part="transfer_p")
        prev_space = cspace
        cur_degree = 1
    while (len(levels) < MAX_LEVELS
           and all(n % 2 == 0 for n in ne)
           and int(np.prod(ne)) // (2 ** space.dim) >= min_elems):
        ne = tuple(n // 2 for n in ne)
        cmesh = subdivided_hyper_rectangle(lo, hi, list(ne),
                                           colorize=True, dim=space.dim)
        # propagate the FINE mesh's boundary-id convention (generator
        # meshes key the id off the local face index)
        side_bid = {}
        for (_, lf, b) in space.mesh.boundary_faces:
            side_bid.setdefault(int(lf), set()).add(int(b))
        if all(len(v) == 1 for v in side_bid.values()):
            for row in cmesh.boundary_faces:
                ids = side_bid.get(int(row[1]))
                if ids:
                    row[2] = next(iter(ids))
        cmesh.periodic = list(mesh.periodic)
        cspace = FESpace(cmesh, cur_degree)
        add_level(cspace, int(round(solver.op.n_q ** (1 / space.dim))))
        prev_space = cspace
        mesh = cmesh
    return levels


class Cycle:
    """One multigrid cycle of ``levels``, linearized once: ``states`` is
    ``make_vcycle``'s per-level (linearization, Dirichlet mask,
    block-Jacobi inverses), and the cycle's parts are methods.  Nothing
    in it refers back to it, so reference counting frees it, and every
    level's state with it, once the last reference to ``apply`` goes:
    when Newton drops the preconditioner."""

    def __init__(self, levels, states, *, coarse_iters, smoother, krylov_m,
                 cycle, level_offset):
        self.levels, self.states = levels, states
        self.coarse_iters, self.smoother = coarse_iters, smoother
        self.krylov_m, self.cycle = krylov_m, cycle
        self.level_offset = level_offset

    def matvec(self, level, v):
        """The level's operator, its Dirichlet rows the identity."""
        lvl = self.levels[level]
        lin, mask, _ = self.states[level]
        zero = torch.zeros_like(v)
        dv = lvl.hc_distribute(torch.where(mask, zero, v))
        dr = lvl.hc_transpose(lvl.op.jvp(lin, dv))
        return torch.where(mask, zero, dr) + torch.where(mask, v, zero)

    def block_jacobi(self, level, v):
        return apply_node_block_state(self.states[level][2], v)

    def solve(self, level, r, m, precond, x0=None, flexible=False):
        """``m`` (F)GMRES steps on level ``level`` from ``x0``."""
        shape = r.shape
        x = gmres_fixed(
            lambda x: self.matvec(level, x.reshape(shape)).reshape(-1),
            r.reshape(-1), x0=None if x0 is None else x0.reshape(-1),
            precond=lambda x: precond(x.reshape(shape)).reshape(-1),
            m=m, flexible=flexible)
        return x.reshape(shape)

    def smooth(self, level, r, z=None):
        """One pre/post smoothing application: z ~ A_level^{-1} r."""
        sm = partial(self.block_jacobi, level)
        with span(SPANS[level + self.level_offset]["smooth"]):
            if self.smoother == "krylov":
                return self.solve(level, r, self.krylov_m, sm, x0=z)
            z0 = OMEGA * sm(r) if z is None else z + OMEGA * sm(
                r - self.matvec(level, z))
            for _ in range(N_SMOOTH - 1):
                z0 = z0 + OMEGA * sm(r - self.matvec(level, z0))
            return z0

    def vcycle(self, level, r):
        mask = self.states[level][1]
        names = SPANS[level + self.level_offset]
        if level + 1 == len(self.levels):
            with span(names["bottom"]):
                return self.solve(level, r, self.coarse_iters,
                                  partial(self.block_jacobi, level))
        z = self.smooth(level, r)
        with span(names["residual"]):
            res = r - self.matvec(level, z)
        with span(names["restrict"]):
            rc = restrict(self.levels[level + 1], res)
            rc = torch.where(self.states[level + 1][1],
                             torch.zeros_like(rc), rc)
        zc = self.coarse_correct(level + 1, rc)
        with span(names["prolong"]):
            zf = prolong(self.levels[level + 1], zc)
            z = z + torch.where(mask, torch.zeros_like(zf), zf)
        return self.smooth(level, r, z=z)

    def coarse_correct(self, level, rc):
        """The level-``level`` correction inside the parent cycle: plain
        recursion (v), doubled (w), or FGMRES-wrapped (k)."""
        wrapped = (self.cycle in ("w", "k")
                   and level + self.level_offset <= CYCLE_LEVELS
                   and level + 1 < len(self.levels))
        if not wrapped:
            return self.vcycle(level, rc)
        if self.cycle == "w":
            zc = self.vcycle(level, rc)
            return zc + self.vcycle(level, rc - self.matvec(level, zc))
        return self.solve(level, rc, CYCLE_M, partial(self.vcycle, level),
                          flexible=True)

    def apply(self, v):
        """One cycle: the preconditioner's application."""
        count("vcycles")
        with span("gmg.cycle", "vcycle_s"):
            if self.level_offset:
                return self.coarse_correct(0, v)
            return self.vcycle(0, v)


def make_vcycle(levels: list[Level], *, coarse_iters: int = 25,
                smoother: str = "jacobi", krylov_m: int = 4,
                cycle: str = "v", level_offset: int = 0):
    """Return builder(u, uprev, fq, alpha0, sdt, fine_mask, pstate=None)
    -> apply(v): one multigrid cycle of the hierarchy, linearized at u.

    smoother: 'jacobi' (``N_SMOOTH`` node-block-Jacobi sweeps damped by
    ``OMEGA``) or 'krylov' (``krylov_m`` GMRES steps preconditioned by
    node-block Jacobi per pre/post smooth).  cycle: 'v'; 'w' (two
    corrections with a residual update between); 'k' (the coarse
    correction is ``CYCLE_M`` FGMRES steps preconditioned by the
    recursive cycle).  The w/k wrap applies to the first
    ``CYCLE_LEVELS`` coarse levels.  The bottom solve is
    GMRES(``coarse_iters``) preconditioned by block-Jacobi.
    ``level_offset`` 1 says that ``levels[0]`` is the first coarse level
    of a larger hierarchy whose finest level lives elsewhere (the
    sharded path, ``parallel/sharded.py``): the cycle is then that
    level's coarse correction, wrapped as its parent's would be.

    ``builder.state(u, uprev, fq, alpha0, sdt, fine_mask)`` returns the
    once-per-linearization state (per level: the operator's
    linearization at the restricted state with its hanging rows filled,
    the Dirichlet mask and the node-block inverses at the restricted
    state, as in the JAX package); pass it as ``pstate`` to reuse it.
    ``apply`` is a ``Cycle``'s bound method: the state lives as long as
    it does.
    """

    def build_state(u, uprev, fq, alpha0, sdt, fine_mask):
        with span("gmg.build"):
            states = []
            ul, upl, fql, mask = u, uprev, fq, fine_mask
            for li, lvl in enumerate(levels):
                op = lvl.op
                if li > 0:
                    ul, upl = lvl.down(ul), lvl.down(upl)
                    fql = u.new_zeros((op.space.n_elements, op.n_q, op.dim))
                    mask = lvl.mask
                blocks = op.node_blocks(ul, mask, upl, fql, alpha0, sdt)
                states.append((op.linearize(lvl.hc_distribute(ul), upl, fql,
                                            alpha0, sdt), mask,
                               node_blocks_to_state("block_jacobi", blocks,
                                                    mask)))
            return states

    def builder(u, uprev, fq, alpha0, sdt, fine_mask, pstate=None):
        if pstate is None:
            pstate = build_state(u, uprev, fq, alpha0, sdt, fine_mask)
        mg = Cycle(levels, pstate, coarse_iters=coarse_iters,
                   smoother=smoother, krylov_m=krylov_m, cycle=cycle,
                   level_offset=level_offset)
        track_state(mg)
        return mg.apply

    builder.state = build_state
    return builder
