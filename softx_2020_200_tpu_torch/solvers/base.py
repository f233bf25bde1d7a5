"""The solver engine: setup, steady/transient stepping, orchestration
(counterpart of ``softx_2020_200_tpu.solvers.base``).

mesh -> DoFs -> constraints -> initial condition -> { steady cycles
(Newton or pseudo-transient continuation) | BDF or SDIRK time loop }
with post-processing, tables, VTU output and checkpoints.

Everything runs on one device given at construction (``device``, CUDA
by default, and ``dtype``, float32 by default, as the CLI).  A Newton
solve is a host loop over device work: each convergence check reads one
number back (see ``solvers/newton.py``), and the engine keeps the counts
in ``self.stats``.

``preconditioner = auto`` resolves to geometric multigrid
(``ops/multigrid.py``) on a lattice with a hierarchy, with FGMRES
outside; a GMG that stalls a linear solve is swapped for block-Jacobi
for the rest of that solve and restored once for the next (see
``_gmg_fallback``).  ``additive_schwarz`` builds its element blocks from
the kernel's tangent once per Newton iteration (``GLSOperator.
element_matrices``).

``mesh adaptation type = kelly`` puts the mesh in a forest
(``fem/forest.py``, on a generated or a gmsh base mesh): the deck's
initial refinement happens inside it, hanging nodes are constrained
(``fem/constraints.py``), GMG coarsens through the forest
(``ops/multigrid.py``), and ``refine_mesh_kelly`` estimates, flags,
refines, coarsens and balances on the host, rebuilds the operator and
carries the solution and the BDF history across (``fem/transfer.py``):
after every ``frequency``-th time step, or between steady cycles.

A checkpoint is the JAX package's ``.npz`` with the same keys (control,
pvd, n_nodes, degree, u, previous, and on a forest its leaves and base
mesh), so a run of either package continues in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time as _time
from types import SimpleNamespace

import numpy as np
import torch

from ..core.bdf import bdf_coefficients
from ..core.expressions import VectorExpression
from ..core.parameters import (BoundaryType, SimulationParameters,
                               TimeSteppingMethod, Verbosity)
from ..core.pvd_handler import PVDHandler
from ..core.sdirk import sdirk_coefficients
from ..core.simulation_control import SimulationControl
from ..core.timer import SectionTimer
from ..fem.constraints import build_hanging_constraints
from ..fem.dof import FESpace
from ..fem.forest import Forest
from ..fem.geometry import det_and_inv
from ..fem.mesh import Manifold, Mesh, generate_mesh
from ..fem.transfer import transfer_solution
from ..ops.linalg import HostSync, gmres
from ..ops.multigrid import build_hierarchy, make_vcycle
from ..ops.operators import assemble
from ..ops.preconditioners import (apply_node_block_state,
                                   build_additive_schwarz,
                                   build_from_node_blocks,
                                   node_blocks_to_state)
from ..utils.tables import Table
from ..utils.vtu import subcell_connectivity, write_vtu
from . import postprocessing as post
from .analytical import l2_error
from .boundary import BoundaryHandler
from .gls import GLSOperator, StabFlags
from .kelly import flag_cells, kelly_estimate
from .newton import (NewtonConfig, NewtonResult, line_search,
                     linear_solve, newton_solve)


def checkpoint_path(prm: SimulationParameters) -> str:
    """``<output path>/<restart filename>``, without the ``.npz``."""
    return os.path.join(prm.simulation_control.output_path,
                        prm.restart.filename)


def write_npz_atomic(path: str, **arrays) -> None:
    """``np.savez`` to ``path + ".npz"`` through a temporary file and
    ``os.replace``: a crash mid-write leaves the last checkpoint whole."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path + ".npz")


def load_checkpoint(path: str):
    """The arrays of ``path + ".npz"`` (no pickles)."""
    return np.load(path + ".npz", allow_pickle=False)


# ----------------------------------------------------------------------
# the forest, shared by the GLS and GD engines
# ----------------------------------------------------------------------
def read_base_mesh(prm: SimulationParameters, dim: int,
                   initial_refinement: int) -> Mesh:
    """The deck's mesh: a gmsh file (``mesh type = gmsh``, ``file name``
    relative to the working directory) or a generated grid, refined
    uniformly ``initial_refinement`` times."""
    if prm.mesh.type == "gmsh":
        from ..fem.gmsh_io import read_msh
        m = read_msh(prm.mesh.file_name, dim)
        return m.refine_uniform(initial_refinement) \
            if initial_refinement else m
    return generate_mesh(prm.mesh.grid_type, prm.mesh.grid_arguments,
                         dim=dim, initial_refinement=initial_refinement)


def add_manifolds(prm: SimulationParameters, mesh: Mesh, dim: int) -> None:
    """The deck's manifolds on ``mesh``'s boundary ids."""
    for m in prm.manifolds.manifolds:
        center = np.array([float(x) for x in m.arg.replace(",", " ").split()]
                          or [0.0] * dim)
        mesh.boundary_manifolds[m.id] = Manifold(m.type, center)


def add_periodic_pairs(prm: SimulationParameters, mesh: Mesh) -> None:
    """The deck's periodic boundary pairs on ``mesh`` (before DoF
    numbering, and on a forest's base mesh before its adjacency)."""
    for bc in prm.boundary_conditions.bcs:
        if bc.type == BoundaryType.periodic:
            pair = (bc.id, bc.periodic_id, bc.periodic_direction)
            if pair not in mesh.periodic:
                mesh.periodic.append(pair)


def new_forest(base: Mesh, initial_refinement: int):
    """A forest on ``base`` refined uniformly ``initial_refinement``
    times, and its mesh: (forest, mesh, elem_of, nc_faces)."""
    forest = Forest(base)
    for _ in range(initial_refinement):
        forest.refine(np.column_stack(forest._leaf_arrays_only()))
    return (forest,) + tuple(forest.build_mesh())


def snapshot_forest(forest):
    """A copy of ``forest``'s leaf sets (base mesh and adjacency shared),
    to transfer fields from after ``forest`` changes."""
    snap = Forest.__new__(Forest)
    snap.base = forest.base
    snap.dim = forest.dim
    snap.leaves = [set(s) for s in forest.leaves]
    snap._adjacency = forest._adjacency
    return snap


def adapt_forest(forest, eta: np.ndarray, ma, dim: int) -> None:
    """Flag by ``eta`` (``flag_cells`` with the deck's fractions), clamp
    to the deck's refinement levels and element budget (the cells of
    largest eta first), then coarsen, refine and balance ``forest``."""
    refine_mask, coarsen_mask = flag_cells(
        eta, fraction_type=ma.fraction_type,
        refine_fraction=ma.fraction_refinement,
        coarsen_fraction=ma.fraction_coarsening)
    b_arr, lvl_arr, idx_arr = forest._leaf_arrays_only()
    E = len(b_arr)
    ref_idx = np.where(refine_mask & (lvl_arr < ma.max_refinement_level))[0]
    budget = (ma.max_number_elements - E) // (2 ** dim - 1)
    if budget < len(ref_idx):
        sel = np.argsort(-eta[ref_idx], kind="stable")
        ref_idx = ref_idx[sel[:max(0, budget)]]
    coa_idx = np.where(coarsen_mask & (lvl_arr > ma.min_refinement_level))[0]
    rows = np.column_stack([b_arr, lvl_arr, idx_arr])
    forest.coarsen(rows[coa_idx])
    forest.refine(rows[ref_idx])
    forest.balance()


def forest_checkpoint(forest) -> dict:
    """The forest's part of a checkpoint: every leaf as a row (base cell,
    level, index...), and the base mesh it must be restored on."""
    rows = [(b,) + leaf for b, leafset in enumerate(forest.leaves)
            for leaf in sorted(leafset)]
    return {"forest_leaves": np.asarray(rows, np.int64),
            "base_vertices": forest.base.vertices,
            "base_cells": forest.base.cells}


def restore_forest(forest, data):
    """Set ``forest``'s leaves from a checkpoint's ``data`` and return its
    (mesh, elem_of, nc_faces); the checkpoint's base mesh must be the
    deck's."""
    if forest is None:
        raise ValueError("checkpoint holds an adapted forest but the deck "
                         "does not enable kelly adaptation")
    base = forest.base
    if (data["base_vertices"].shape != base.vertices.shape
            or not np.allclose(data["base_vertices"], base.vertices)
            or not np.array_equal(data["base_cells"], base.cells)):
        raise ValueError("checkpoint base mesh does not match the deck's")
    leaves = [set() for _ in range(base.n_cells)]
    for row in data["forest_leaves"]:
        leaves[int(row[0])].add(tuple(int(x) for x in row[1:]))
    forest.leaves = leaves
    return forest.build_mesh()


def new_stats() -> dict:
    """The engine's counts over all its Newton solves (the CLI prints
    them as the ``Newton summary`` line)."""
    return {"newton_solves": 0, "newton_iterations": 0,
            "linear_iterations": 0, "host_syncs": 0,
            "line_search_evaluations": 0, "linear_restarts": 0,
            "solves_above_tolerance": 0, "newton_seconds": 0.0}


def record_solve(stats: dict, res, seconds: float, tolerance: float):
    """Add one Newton solve's counts to ``stats``."""
    stats["newton_solves"] += 1
    stats["newton_iterations"] += res.n_iterations
    stats["linear_iterations"] += res.linear_iters
    stats["host_syncs"] += res.host_syncs
    stats["line_search_evaluations"] += res.line_search_evals
    stats["linear_restarts"] += res.linear_restarts
    stats["solves_above_tolerance"] += int(
        res.res_history[res.n_iterations] > tolerance)
    stats["newton_seconds"] += seconds


class GLSNavierStokesSolver:
    """Monolithic equal-order GLS solver (GLSNavierStokesSolver<dim>)."""

    def __init__(self, prm: SimulationParameters, mesh: Mesh | None = None,
                 *, device: torch.device | str = "cuda",
                 dtype: torch.dtype = torch.float32):
        self.prm = prm
        self.dim = prm.dim
        self.device = torch.device(device)
        self.dtype = dtype
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the solver runs on CUDA unless device='cpu' "
                               "is given, and CUDA is not available")
        if self.device.type == "cuda":
            # f32 means f32: no TF32 in any matrix product
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.pvd = PVDHandler()
        self.control = SimulationControl(prm.simulation_control)
        self.timer = SectionTimer()
        self.tables: dict[str, list] = {"L2": [], "forces": [], "ke": [],
                                        "enstrophy": []}
        self._force_tables: dict[int, Table] = {}
        self._torque_tables: dict[int, Table] = {}
        self.stats = new_stats()
        self._mesh = mesh
        self.forest = None
        self._elem_of = None
        self.setup()

    # ------------------------------------------------------------------
    def setup(self, mesh: Mesh | None = None, nc_faces=None) -> None:
        """read_mesh + setup_dofs + operator/BC construction.  With Kelly
        adaptation the first call puts the base mesh (with its manifolds
        and periodic pairs) in a forest and refines it there; a later
        call takes the adapted forest's mesh and non-conforming faces."""
        prm = self.prm
        if mesh is not None:
            self._mesh = mesh
        if self._mesh is None:
            if prm.mesh_adaptation.type == "kelly":
                base = read_base_mesh(prm, self.dim, 0)
                add_manifolds(prm, base, self.dim)
                add_periodic_pairs(prm, base)
                self.forest, self._mesh, self._elem_of, nc_faces = \
                    new_forest(base, prm.mesh.initial_refinement)
            else:
                self._mesh = read_base_mesh(prm, self.dim,
                                            prm.mesh.initial_refinement)
                add_manifolds(prm, self._mesh, self.dim)
        # periodic declarations reach the mesh before DoF numbering
        add_periodic_pairs(prm, self._mesh)

        kw = dict(dtype=self.dtype, device=self.device)
        self.space = FESpace(self._mesh, prm.fem.velocity_order)
        self._nc_faces = nc_faces or []
        self.hc = build_hanging_constraints(self.space, self._nc_faces).to(
            self.device, self.dtype)
        stab = StabFlags(
            supg=prm.stabilization.supg,
            pspg=prm.stabilization.pspg,
            gls_viscous_adjoint=prm.stabilization.gls_viscous_adjoint,
            lsic=prm.stabilization.lsic,
            frozen_tau=prm.stabilization.frozen_tau_jacobian)
        self.op = GLSOperator(
            self.space, prm.physical_properties.kinematic_viscosity,
            n_q1d=prm.fem.n_quadrature_points_1d, stab=stab,
            state_dtype=(torch.bfloat16 if prm.linear_solver
                         .jacobian_state_precision == "bf16" else None),
            **kw)
        self.bh = BoundaryHandler(self.space, prm.boundary_conditions, **kw)

        self.source = (VectorExpression(prm.source_term.xyz)
                       if prm.source_term.enable else None)
        self.exact = (VectorExpression(prm.analytical_solution.uvwp)
                      if prm.analytical_solution.enable else None)
        # MMS: the forcing derived from the exact solution by autodiff
        # when the deck's source expression is the word 'mms'
        self._mms_source = None
        if (self.source is not None
                and prm.source_term.xyz.strip().lower().startswith("mms")):
            if self.exact is None:
                raise ValueError("source 'mms' requires an analytical solution")
            from .analytical import mms_source
            self._mms_source = mms_source(
                self.exact, prm.physical_properties.kinematic_viscosity,
                self.dim)

        ls = prm.linear_solver
        nls = prm.nonlinear_solver
        self.newton_cfg = NewtonConfig(
            tolerance=nls.tolerance,
            max_iterations=nls.max_iterations,
            max_halvings=nls.max_line_search_halvings,
            method="bicgstab" if ls.method == "bicgstab" else "gmres",
            gmres_restart=ls.max_krylov_vectors,
            max_krylov_cycles=max(1, ls.max_iters // ls.max_krylov_vectors),
            relative_residual=ls.relative_residual,
            minimum_residual=ls.minimum_residual,
            skip_iterations=nls.skip_iterations)
        self.precond_kind = ls.resolved_preconditioner()
        self._vcycle = None
        # a mesh rebuild drops a stashed fallen-back GMG (its levels
        # belong to the old mesh); the strike count survives it
        self._gmg_stash = None
        self._gmg_strikes = getattr(self, "_gmg_strikes", 0)
        if self.precond_kind == "gmg" and self._gmg_strikes >= 2:
            print("linear solver: GMG stays evicted on the adapted mesh "
                  "(2 stagnation strikes); using block-Jacobi")
            self.precond_kind = "block_jacobi"
        self.mg_levels = []
        if self.precond_kind == "gmg":
            self.mg_levels = build_hierarchy(self)
            if len(self.mg_levels) < 2:
                # no hierarchy on this mesh: block-Jacobi
                self.precond_kind = "block_jacobi"
            else:
                self._vcycle = make_vcycle(
                    self.mg_levels,
                    smoother=ls.resolved_mg_smoother(
                        self.control.is_steady(), degree=self.space.degree),
                    krylov_m=ls.mg_krylov_vectors,
                    cycle=ls.resolved_mg_cycle())
                self.newton_cfg = dataclasses.replace(self.newton_cfg,
                                                      flexible=True)
        if ls.preconditioner == "auto" and not prm.test.enable:
            what = (f"gmg ({len(self.mg_levels)} levels)"
                    if self._vcycle is not None else
                    "block_jacobi (no multigrid hierarchy on this mesh)")
            print(f"linear solver: preconditioner 'auto' resolves to {what}")
        self._zero_prev = torch.zeros((self.space.n_nodes, self.dim), **kw)
        # the additive-Schwarz inverses of the last Newton iteration,
        # dropped before the next ones are built
        self._schwarz = None

    # ------------------------------------------------------------------
    def _source_at(self, t, qpts=None):
        qpts = qpts if qpts is not None else self.op.qpts_phys
        if self._mms_source is not None:
            return self._mms_source(qpts, t)
        if self.source is None:
            return torch.zeros_like(qpts)
        f = self.source.spatial(qpts, t)
        return f[..., :self.dim]

    def _make_problem(self, uprev_combo, t, alpha0, sdt):
        """(constrain, residual, jacobian, node_block_state, mask) for one
        nonlinear solve."""
        op, bh, hc = self.op, self.bh, self.hc
        mask = bh.mask
        if hc.n:
            # constrained (hanging) dofs act like extra Dirichlet rows
            mask = mask.clone()
            mask[hc.ids] = True
        fq = self._source_at(t)

        def constrain(u0):
            u0 = bh.constrain(u0, t)
            return bh.slip_project(hc.distribute(u0))

        def residual(u):
            u = hc.distribute(u)
            R = op.residual_free(u, uprev_combo, fq, alpha0, sdt)
            R = hc.distribute_transpose(R)
            R = torch.where(mask, torch.zeros_like(R), R)
            # rotated slip rows: tangential residual + u.n identity
            return bh.slip_residual(R, u)

        def jacobian(u):
            state = op.linearize(hc.distribute(u), uprev_combo, fq,
                                 alpha0, sdt)

            def matvec(v):
                v = hc.distribute(v)
                dR = hc.distribute_transpose(op.jvp(state, v))
                dR = torch.where(mask, torch.zeros_like(dR), dR)
                return bh.slip_residual(dR, v)

            return matvec

        def node_block_state(u):
            blocks = op.node_blocks(hc.distribute(u), mask, uprev_combo,
                                    fq, alpha0, sdt)
            blocks = bh.slip_project_blocks(blocks)
            return node_blocks_to_state(self.precond_kind, blocks, mask)

        def precond_builder(u):
            if self._vcycle is not None:
                # the cycle's state is built here, once per Newton
                # iteration
                return self._vcycle(hc.distribute(u), uprev_combo, fq,
                                    alpha0, sdt, mask)
            if self.precond_kind == "additive_schwarz":
                self._schwarz = None
                A_e = op.element_matrices(hc.distribute(u), mask,
                                          uprev_combo, fq, alpha0, sdt)
                self._schwarz = build_additive_schwarz(
                    A_e, op.elem_nodes, op.amap_idx, op.inv_mult, mask)
                return lambda v: self._schwarz.apply(v)
            blocks = op.node_blocks(hc.distribute(u), mask, uprev_combo,
                                    fq, alpha0, sdt)
            blocks = bh.slip_project_blocks(blocks)
            return build_from_node_blocks(self.precond_kind, blocks,
                                          mask).apply

        return (constrain, residual, jacobian, node_block_state,
                precond_builder)

    def _gmg_fallback(self) -> bool:
        """Swap a stalling GMG preconditioner for block-Jacobi (the linear
        solve ran out of its budget above its tolerance); the Newton
        iteration is then retried.  On steady strongly convective decks
        the rediscretized coarse correction can amplify smooth
        convective modes while block-Jacobi FGMRES converges; where GMG
        works it is much stronger, so the swap is undone once for the
        next solve (``_gmg_probation``).  Returns whether it swapped."""
        if self._vcycle is None:
            return False
        print("linear solver: GMG stagnated (linear budget exhausted); "
              "falling back to block-Jacobi preconditioning")
        self._gmg_strikes += 1
        self._gmg_stash = self._vcycle
        self._vcycle = None
        self.precond_kind = "block_jacobi"
        return True

    def _gmg_probation(self) -> None:
        """Restore a fallen-back GMG for the next nonlinear solve, while it
        has fewer than two strikes; after the second the swap stays."""
        if self._gmg_stash is not None and self._gmg_strikes < 2:
            self._vcycle, self._gmg_stash = self._gmg_stash, None
            self.precond_kind = "gmg"

    def _check_preconditioner(self) -> None:
        if self.precond_kind not in ("jacobi", "block_jacobi", "gmg",
                                     "additive_schwarz"):
            raise ValueError(
                f"unknown preconditioner {self.precond_kind!r}")

    def _newton(self, u0, uprev_combo, t, alpha0, sdt):
        """One nonlinear solve (steady: alpha0 = sdt = 0)."""
        self._gmg_probation()
        self._check_preconditioner()
        t0 = _time.perf_counter()
        (constrain, residual, jacobian, node_block_state,
         precond_builder) = self._make_problem(uprev_combo, t, alpha0, sdt)
        u0 = constrain(u0)
        if (self.prm.nonlinear_solver.solver == "skip_newton"
                and self.precond_kind in ("jacobi", "block_jacobi")):
            # reference SkipNewtonNonLinearSolver: the preconditioner
            # state is rebuilt every `skip iterations`
            res = newton_solve(residual, jacobian, u0,
                               config=self.newton_cfg,
                               precond_state_fn=node_block_state,
                               precond_apply_fn=apply_node_block_state)
        else:
            res = newton_solve(residual, jacobian, u0,
                               precond_builder=precond_builder,
                               config=self.newton_cfg,
                               on_linear_stall=self._gmg_fallback)
        if self.hc.n:
            res = res._replace(u=self.hc.distribute(res.u))
        record_solve(self.stats, res, _time.perf_counter() - t0,
                     self.newton_cfg.tolerance)
        return res

    # ------------------------------------------------------------------
    def initial_condition(self):
        """set_initial_condition: none / nodal / L2projection / viscous."""
        prm = self.prm
        N, c = self.space.n_nodes, self.dim + 1
        kw = dict(dtype=self.dtype, device=self.device)
        u = torch.zeros((N, c), **kw)
        if prm.initial_conditions.type == "nodal":
            expr = VectorExpression(prm.initial_conditions.uvwp)
            vals = expr.spatial(self.bh.node_coords, 0.0)
            u = vals[:, :c] if vals.shape[-1] >= c else torch.nn.functional.pad(
                vals, (0, c - vals.shape[-1]))
        elif prm.initial_conditions.type == "L2projection":
            expr = VectorExpression(prm.initial_conditions.uvwp)
            u = self._l2_project(expr)
        elif prm.initial_conditions.type == "viscous":
            # steady pre-solve with the IC viscosity, then restore the
            # run operator
            op_run = self.op
            self.op = GLSOperator(self.space,
                                  prm.initial_conditions.viscosity,
                                  n_q1d=prm.fem.n_quadrature_points_1d,
                                  stab=op_run.stab, **kw)
            try:
                res = self._newton(self.bh.constrain(u, 0.0),
                                   self._zero_prev, 0.0, 0.0, 0.0)
            finally:
                self.op = op_run
            u = res.u
        return self.bh.constrain(u, 0.0)

    def _l2_project(self, expr):
        """True L2 projection onto the FE space: matrix-free mass solve
        with GMRES and lumped-mass Jacobi preconditioning."""
        op = self.op
        c = self.dim + 1
        J = torch.einsum("eni,qnj->eqij", op.xe, op.G)
        detJ, _ = det_and_inv(J)
        wdet = detJ * op.w[None, :]                      # [E, nq]

        fvals = expr.spatial(op.qpts_phys, 0.0)[..., :c]  # [E, nq, c]
        rhs = assemble(torch.einsum("qn,eq,eqc->enc", op.B, wdet, fvals),
                       op.amap_idx)
        lumped = assemble(torch.einsum("qn,eq->en", op.B, wdet)[:, :, None],
                          op.amap_idx)[:, 0]

        def mass_apply(v_flat):
            ve = v_flat.reshape(op.n_nodes, c)[op.elem_nodes]
            vq = torch.einsum("qn,enc->eqc", op.B, ve)
            back = torch.einsum("qn,eq,eqc->enc", op.B, wdet, vq)
            return assemble(back, op.amap_idx).reshape(-1)

        lumped_flat = torch.repeat_interleave(lumped, c)
        x, _, _, _ = gmres(
            mass_apply, rhs.reshape(-1), precond=lambda v: v / lumped_flat,
            m=50, max_restarts=10,
            atol=1e-10 * float(torch.linalg.vector_norm(rhs)))
        return x.reshape(op.n_nodes, c)

    def solve_steady(self, u0=None, verbose: bool | None = None):
        """One steady nonlinear solve; returns (u, NewtonResult)."""
        if u0 is None:
            u0 = self.initial_condition()
        if self.prm.nonlinear_solver.solver == "pseudo_transient":
            res = self.solve_steady_ptc(u0, verbose=verbose)
            return res.u, res
        res = self._newton(u0, self._zero_prev, 0.0, 0.0, 0.0)
        self._log_newton(res, verbose)
        return res.u, res

    def solve_steady_ptc(self, u0, verbose: bool | None = None):
        """Pseudo-transient continuation (``solver = pseudo_transient``),
        as in the JAX package: one backward-Euler Newton iteration per
        pseudo-step, combo = -u_k/dt frozen at its start, with dt grown by
        switched evolution relaxation on the steady residual
        (dt_{k+1} = dt_k ||R_k||/||R_{k+1}||, the growth clamped to
        [0.1, ptc_growth], dt capped at ptc_max_dt) until the steady
        residual meets the nonlinear tolerance.  The linear solve stops at
        ``max(relative_residual * ||R_be||, minimum_residual)`` of the
        backward-Euler residual; when its cycles run out, GMG falls back
        to block-Jacobi and the same pseudo-step is retried.  The stall
        guard acts once dt has reached ptc_max_dt.  Returns a
        NewtonResult whose ``n_iterations`` counts the pseudo-steps and
        whose history (length ptc_max_steps + 1) holds the steady
        residuals; the best iterate is returned."""
        self._gmg_probation()
        self._check_preconditioner()
        nls, cfg = self.prm.nonlinear_solver, self.newton_cfg
        if verbose is None:
            verbose = (nls.verbosity is Verbosity.verbose
                       and not self.prm.test.enable)
        t0 = _time.perf_counter()
        sync = HostSync()
        d = self.dim
        constrain, residual = self._make_problem(self._zero_prev, 0.0, 0.0,
                                                 0.0)[:2]
        u = constrain(u0)
        rs = sync(torch.linalg.vector_norm(residual(u)))
        dt = nls.ptc_initial_dt
        maxk = nls.ptc_max_steps
        hist = np.full(maxk + 1, np.nan)
        alphas = np.full(maxk, np.nan)
        hist[0] = rs
        k = lin_total = ls_evals = restarts = 0

        def stalled():
            # the floor guard, once the pseudo-step is effectively
            # infinite (the residual is not monotone while dt ramps)
            W = cfg.stall_window
            return (dt >= nls.ptc_max_dt and k >= W
                    and rs > cfg.stall_factor * hist[k - W])

        u_best, n_best = u, rs
        while rs > cfg.tolerance and k < maxk and not stalled():
            alpha0 = 1.0 / dt
            combo = -u[:, :d] * alpha0
            (_, residual_be, jacobian, _,
             precond_builder) = self._make_problem(combo, 0.0, alpha0,
                                                   alpha0)
            Rbe = residual_be(u)
            rbe = sync(torch.linalg.vector_norm(Rbe))
            step, lin_rn, lin_atol, lin_it, cycles = linear_solve(
                jacobian(u), precond_builder(u), Rbe, rbe, cfg, sync)
            lin_total += lin_it
            restarts += max(cycles - 1, 0)
            if lin_rn > lin_atol and self._gmg_fallback():
                continue
            u, _, _, alpha, evals = line_search(residual_be, u, step, rbe,
                                                cfg, sync)
            ls_evals += evals
            u = constrain(u)
            rs_new = sync(torch.linalg.vector_norm(residual(u)))
            growth = min(nls.ptc_growth, max(0.1, rs / max(rs_new, 1e-300)))
            dt = min(nls.ptc_max_dt, dt * growth)
            rs = rs_new
            k += 1
            hist[k] = rs
            alphas[k - 1] = alpha
            if rs < n_best:
                u_best, n_best = u, rs
            if verbose:
                prec = self.prm.simulation_control.log_precision
                print(f"PTC step {k:3d}  dt = {dt:.3e}  "
                      f"Residual: {rs:.{prec}e}")
        res = NewtonResult(u=u_best, res_history=hist, n_iterations=k,
                           linear_iters=lin_total, alphas=alphas,
                           host_syncs=sync.count, line_search_evals=ls_evals,
                           linear_restarts=restarts)
        record_solve(self.stats, res, _time.perf_counter() - t0,
                     cfg.tolerance)
        return res

    def solve_sdirk_step(self, u, t_old, dt, order, verbose=None):
        """One SDIRK22/SDIRK33 step (``order`` stages), as in the JAX
        package.  Stage s solves with udot = (u_s - u_n - dt sum_{j<s}
        A[s,j] k_j) / (dt A[s,s]): alpha0 = 1/(dt A[s,s]), the rest in
        the combo term, from the previous stage's u; its derivative
        k_s = alpha0 u_s + combo (velocity) feeds the later stages.
        Both schemes are stiffly accurate: u_{n+1} is the last stage.
        Returns (u_{n+1}, the last stage's NewtonResult)."""
        table = sdirk_coefficients(order, dt)
        A, c = table[:, :order], table[:, order]
        d = self.dim
        u_n = u
        ks = []
        res = None
        for s_i in range(order):
            gamma = A[s_i, s_i]
            alpha0 = 1.0 / (dt * gamma)
            combo = -u_n[:, :d] * alpha0
            for j in range(s_i):
                combo = combo - (A[s_i, j] / gamma) * ks[j]
            res = self._newton(u, combo, t_old + c[s_i] * dt, alpha0,
                               1.0 / dt)
            self._log_newton(res, verbose)
            u = res.u
            ks.append(alpha0 * u[:, :d] + combo)
        return u, res

    def solve_transient_step(self, u, previous, t, dts, order, verbose=None):
        """One implicit BDF step.

        previous: list of earlier solutions, newest first (u^{n-1}, ...).
        dts: step sizes, dts[0] = current. order: effective BDF order.
        Returns (u_new, NewtonResult).
        """
        alpha = bdf_coefficients(order, dts)
        combo = torch.zeros_like(self._zero_prev)
        for i in range(1, order + 1):
            combo = combo + float(alpha[i]) * previous[i - 1][:, :self.dim]
        res = self._newton(u, combo, t, float(alpha[0]),
                           1.0 / float(dts[0]))
        self._log_newton(res, verbose)
        return res.u, res

    # ------------------------------------------------------------------
    def _after_step(self, u, t):
        """postprocess + L2 print + output, once per full time step."""
        prm = self.prm
        self.control.cfl = float(self.op.cfl(u, self.control.dt))
        with self.timer.section("postprocess"):
            self.postprocess(u, t)
            if self.exact is not None and (
                    prm.analytical_solution.verbosity is Verbosity.verbose
                    or prm.test.enable):
                ev, _ = self.l2_errors(u, t)
                prec = prm.simulation_control.log_precision
                print(f"L2 error velocity : {ev:.{prec}e}")
        if self.control.is_output_iteration():
            self.write_output(u, t)

    def run_transient(self, u0=None, on_step=None, verbose=None,
                      history_from_exact: bool = False):
        """Transient BDF or SDIRK time loop, with the JAX package's
        startup sub-stepping: with ``startup time scaling`` s in (0, 1)
        the first step(s) of a BDF2/3 run are split into lower-order
        sub-steps of sizes (s dt, (1-s) dt) (not under SDIRK, not after a
        restart).  With ``history_from_exact`` the BDF history is the
        analytical solution at t - dt and t - 2 dt on the space's nodes
        instead, the dt history holds the target order's steps (full
        order from the first step, as temporal-order checks need) and
        there is no startup sub-stepping.  A restart reads the
        checkpoint before that is decided; a checkpoint is written after
        every ``frequency``-th step.  ``on_step(solver, u, t)`` runs
        after every step.  Returns the final solution."""
        ctrl = self.control
        sdirk_order = (int(ctrl.method.value[-1])
                       if ctrl.method.is_sdirk else 0)
        target_order = ctrl.method.bdf_order
        if target_order == 0 and sdirk_order == 0:
            raise ValueError("run_transient requires a bdf/sdirk method")
        target_order = max(target_order, 1)
        if u0 is None:
            u0 = self.initial_condition()
        u = u0
        previous = [u0] * 3    # newest first
        if history_from_exact:
            if self.exact is None:
                raise ValueError("history_from_exact needs an analytical "
                                 "solution")
            c = self.dim + 1
            previous = [u0] + [
                self.exact.spatial(self.bh.node_coords,
                                   ctrl.time - i * ctrl.dt)[:, :c]
                for i in (1, 2)]
            ctrl.dt_history = [ctrl.dt] * target_order

        prm = self.prm
        if prm.restart.restart:
            u, previous = self.read_checkpoint()
        s_scale = prm.simulation_control.startup_timestep_scaling
        startup_left = 0
        if (target_order >= 2 and not sdirk_order and 0.0 < s_scale < 1.0
                and not history_from_exact and not prm.restart.restart):
            startup_left = target_order - 1

        while not ctrl.is_at_end():
            ctrl.integrate()
            order = ctrl.effective_bdf_order()
            t = ctrl.time
            if startup_left > 0:
                k = target_order - startup_left   # 1st split: k=1, ...
                dt_full = ctrl.dt_history[0]
                dt_a = s_scale * dt_full
                dt_b = dt_full - dt_a
                dts_a = [dt_a] + ctrl.dt_history[1:]
                with self.timer.section("solve"):
                    u, _ = self.solve_transient_step(
                        u, previous, t - dt_b, dts_a,
                        min(k, len(dts_a)), verbose=verbose)
                previous = [u] + previous[:2]
                dts_b = [dt_b, dt_a] + ctrl.dt_history[1:]
                with self.timer.section("solve"):
                    u, _ = self.solve_transient_step(
                        u, previous, t, dts_b,
                        min(k + 1, len(dts_b)), verbose=verbose)
                previous = [u] + previous[:2]
                # the true sub-step sizes feed later variable-dt weights
                ctrl.dt_history = ([dt_b, dt_a]
                                   + ctrl.dt_history[1:])[:4]
                startup_left -= 1
                self._after_step(u, t)
                self._checkpoint_after(u, previous)
                if on_step is not None:
                    on_step(self, u, t)
                continue
            if (prm.simulation_control.method is not TimeSteppingMethod.steady
                    and not prm.test.enable and verbose is not False):
                prec = prm.simulation_control.log_precision
                print(f"*** Time step : {ctrl.iteration}  "
                      f"time = {t:.{prec}g}  dt = {ctrl.dt:.{prec}g} ***")
            with self.timer.section("solve"):
                if sdirk_order:
                    u, _ = self.solve_sdirk_step(
                        u, t - ctrl.dt, ctrl.dt, sdirk_order,
                        verbose=verbose)
                else:
                    u, _ = self.solve_transient_step(
                        u, previous, t, ctrl.dts(), order, verbose=verbose)
            previous = [u] + previous[:2]
            self._after_step(u, t)
            ma = prm.mesh_adaptation
            if (ma.type == "kelly" and ma.frequency > 0
                    and ctrl.iteration % ma.frequency == 0):
                # the solution and the BDF history move to the new mesh
                fields = self.refine_mesh_kelly([u] + previous)
                u, previous = fields[0], list(fields[1:])
            # the checkpoint comes after the adaptation, so that a restart
            # resumes on the adapted forest
            self._checkpoint_after(u, previous)
            if on_step is not None:
                on_step(self, u, t)
            if prm.timer.type == "iteration":
                print(self.timer.report())
                self.timer.reset()
        self.write_tables()
        if prm.timer.type == "end":
            print(self.timer.report())
        return u

    def solve(self, on_cycle=None):
        """Full orchestration: steady mesh-adaptation cycles (Kelly,
        uniform or none), each cycle a solve + L2-error table row, a
        Kelly cycle starting from the transferred solution; transient
        decks delegate to ``run_transient``.  Returns the final
        solution."""
        prm = self.prm
        if not self.control.is_steady():
            return self.run_transient(on_step=on_cycle)
        n_cycles = prm.simulation_control.number_mesh_adaptation + 1
        u = None
        for cycle in range(n_cycles):
            u0 = None
            if cycle > 0:
                if prm.mesh_adaptation.type == "kelly":
                    u0 = self.refine_mesh_kelly([u])[0]
                elif prm.mesh_adaptation.type in ("uniform", "none"):
                    self.setup(self._mesh.refine_uniform(1))
                else:
                    raise ValueError(
                        f"unknown adaptation type "
                        f"{prm.mesh_adaptation.type!r}")
            with self.timer.section("solve"):
                u, _ = self.solve_steady(u0=u0)
            if self.exact is not None:
                ev, ep = self.l2_errors(u)
                self.tables["L2"].append(
                    {"cells": self.space.n_elements,
                     "dofs": self.space.n_dofs(self.dim + 1),
                     "error_velocity": ev, "error_pressure": ep})
                if (prm.analytical_solution.verbosity is Verbosity.verbose
                        or prm.test.enable):
                    prec = prm.simulation_control.log_precision
                    print(f"L2 error velocity : {ev:.{prec}e}  "
                          f"L2 error pressure: {ep:.{prec}e}")
            with self.timer.section("postprocess"):
                self.postprocess(u, 0.0)
            if prm.simulation_control.output_frequency > 0:
                self.write_output(u, 0.0)
            if on_cycle is not None:
                on_cycle(self, u, 0.0)
        self.write_tables()
        if self.tables["L2"]:
            t = Table(["cells", "dofs", "error_velocity", "error_pressure"])
            for row in self.tables["L2"]:
                t.add_row(row)
            t.write(os.path.join(prm.simulation_control.output_path,
                                 prm.analytical_solution.filename + ".dat"))
        if prm.timer.type == "end":
            print(self.timer.report())
        return u

    # ------------------------------------------------------------------
    # adaptive mesh refinement
    # ------------------------------------------------------------------
    def refine_mesh_kelly(self, fields: list):
        """Kelly estimate -> flag -> forest coarsen/refine/balance ->
        rebuild the space and operator -> transfer every field (the
        solution and the BDF history, [N, c*] tensors on the current
        space).  The estimate runs on the host in NumPy from one copy of
        u, as in the JAX package.  Returns the fields on the new space."""
        if self.forest is None:
            raise ValueError("kelly adaptation requires the forest path "
                             "(set mesh adaptation type = kelly)")
        ma = self.prm.mesh_adaptation
        view = SimpleNamespace(space=self.space, dim=self.dim,
                               xe=self.space.element_coords(),
                               elem_nodes=self.space.elem_nodes)
        with self.timer.section("kelly_estimate"):
            eta = kelly_estimate(view, fields[0].detach().cpu().numpy(),
                                 variable=ma.variable,
                                 nc_faces=self._nc_faces)
        E = self.space.n_elements
        old_space, old_elem_of = self.space, self._elem_of
        snap = snapshot_forest(self.forest)
        with self.timer.section("refine"):
            adapt_forest(self.forest, eta, ma, self.dim)
            mesh, self._elem_of, ncf = self.forest.build_mesh()
        with self.timer.section("setup"):
            self.setup(mesh=mesh, nc_faces=ncf)
        with self.timer.section("transfer"):
            out = transfer_solution(old_space, snap, old_elem_of,
                                    self.space, self.forest, self._elem_of,
                                    fields)
        if not self.prm.test.enable:
            print(f"Mesh adaptation: {E} -> {self.space.n_elements} "
                  f"cells, {self.space.n_dofs(self.dim + 1)} dofs")
        return out

    # ------------------------------------------------------------------
    # postprocessing
    # ------------------------------------------------------------------
    def _pin_pressure(self, u):
        """Remove the constant-pressure nullspace component before force
        and torque integration on decks where nothing fixes the pressure
        level (no outlet BC).  Volume-weighted mean via the operator's
        quadrature, on the host in float64 (once per output step)."""
        if any(bc.type == BoundaryType.outlet
               for bc in self.prm.boundary_conditions.bcs):
            return u
        cache = getattr(self, "_pin_cache", None)
        if cache is None or cache[0] is not self.op:
            op = self.op
            J = np.einsum("eni,qnj->eqij", self.space.element_coords(),
                          op.G.cpu().double().numpy())
            wdet = np.linalg.det(J) * op.w.cpu().double().numpy()
            cache = (op, wdet, float(wdet.sum()),
                     op.B.cpu().double().numpy())
            self._pin_cache = cache
        _, wdet, vol, B = cache
        u_np = u.detach().cpu().numpy()
        pe = u_np[self.space.elem_nodes, -1]                 # [E, nn]
        pq = np.einsum("qn,en->eq", B, pe)
        mean = float(np.sum(wdet * pq) / vol)
        return torch.as_tensor(u_np - mean * np.eye(u_np.shape[1])[-1],
                               dtype=u.dtype, device=u.device)

    def postprocess(self, u, t: float) -> None:
        prm = self.prm
        prec = prm.forces.output_precision
        it = self.control.iteration
        if (prm.forces.calculate_forces
                or prm.forces.calculate_torques) and \
                it % prm.forces.calculation_frequency == 0:
            u = self._pin_pressure(u)
        if prm.forces.calculate_forces and \
                it % prm.forces.calculation_frequency == 0:
            with self.timer.section("calculate_forces"):
                for bid, faces in sorted(self.space.boundary_faces.items()):
                    f = post.forces_on_boundary(self.op, u, faces)
                    f = f.cpu().numpy()
                    tab = self._force_tables.setdefault(
                        bid, Table(["time"] + [f"f_{ax}" for ax in
                                               "xyz"[:self.dim]],
                                   precision=prec))
                    tab.add_row([t] + list(map(float, f)))
                    if prm.forces.verbosity is Verbosity.verbose \
                            or prm.test.enable:
                        lp = prm.simulation_control.log_precision
                        comps = " ".join(f"{v:.{lp}e}" for v in f)
                        print(f"Force boundary {bid} : {comps}")
        if prm.forces.calculate_torques and \
                it % prm.forces.calculation_frequency == 0:
            # torques about the PER-BOUNDARY center of rotation
            cor = {bc.id: np.asarray(bc.center_of_rotation(self.dim))
                   for bc in prm.boundary_conditions.bcs}
            with self.timer.section("calculate_torques"):
                for bid, faces in sorted(self.space.boundary_faces.items()):
                    tq = post.torques_on_boundary(
                        self.op, u, faces,
                        center=cor.get(bid, np.zeros(self.dim)))
                    tq = tq.cpu().numpy()
                    tab = self._torque_tables.setdefault(
                        bid, Table(["time"] + [f"T_{i}" for i in
                                               range(tq.shape[0])],
                                   precision=prec))
                    tab.add_row([t] + list(map(float, tq)))
        pp = prm.post_processing
        if (pp.calculate_kinetic_energy or pp.calculate_enstrophy) and \
                it % pp.calculation_frequency == 0:
            with self.timer.section("postprocess_energy"):
                row = {"time": t}
                if pp.calculate_kinetic_energy:
                    row["kinetic-energy"] = float(
                        post.kinetic_energy(self.op, u))
                    self.tables["ke"].append((t, row["kinetic-energy"]))
                if pp.calculate_enstrophy:
                    row["enstrophy"] = float(post.enstrophy(self.op, u))
                    self.tables["enstrophy"].append((t, row["enstrophy"]))
                if pp.verbosity is Verbosity.verbose or prm.test.enable:
                    msg = "  ".join(f"{k}: {v:.6e}" for k, v in row.items()
                                    if k != "time")
                    print(msg)

    def write_tables(self) -> None:
        """Write force/torque/KE tables as .dat files (reference format)."""
        prm = self.prm
        outdir = prm.simulation_control.output_path
        for bid, tab in self._force_tables.items():
            tab.write(os.path.join(
                outdir, f"{prm.forces.force_output_name}.{bid}.dat"))
        for bid, tab in self._torque_tables.items():
            tab.write(os.path.join(
                outdir, f"{prm.forces.torque_output_name}.{bid}.dat"))
        pp = prm.post_processing
        for key, name in (("ke", pp.kinetic_energy_name),
                          ("enstrophy", pp.enstrophy_name)):
            if self.tables[key]:
                t = Table(["time", name])
                for row in self.tables[key]:
                    t.add_row(list(row))
                t.write(os.path.join(outdir, f"{name}.dat"))

    def write_output(self, u, t: float) -> None:
        """VTU + PVD of velocity, pressure, vorticity and Q-criterion."""
        prm = self.prm
        sc = prm.simulation_control
        with self.timer.section("output"):
            it = self.control.iteration
            un = u.detach().cpu().numpy()
            pdata = {"velocity": un[:, :self.dim],
                     "pressure": un[:, self.dim],
                     "vorticity": post.vorticity_field(
                         self.op, u).cpu().numpy(),
                     "q_criterion": post.q_criterion_field(
                         self.op, u).cpu().numpy()}
            s = max(1, sc.subdivision)
            if s in (1, self.space.degree):
                # shared-node path: Qk elements as k^dim linear subcells
                points = self.space.nodes
                cells = subcell_connectivity(self.space.elem_nodes,
                                             self.space.degree, self.dim)
            else:
                # deck `subdivision`: per-element (s+1)^dim patches
                from ..utils.vtu import subdivide_patches
                points, cells, pdata = subdivide_patches(
                    self.space, pdata, s)
            basename = f"{sc.output_name}.{it:05d}"
            if sc.group_files > 1:
                from ..utils.vtu import write_grouped_output
                name = write_grouped_output(
                    sc.output_path, basename, points, cells, pdata,
                    sc.group_files)
            else:
                name = basename + ".vtu"
                write_vtu(os.path.join(sc.output_path, name),
                          points, cells, pdata)
            self.pvd.append(t, name)
            self.pvd.write(os.path.join(
                sc.output_path, sc.output_name + ".pvd"))

    # ------------------------------------------------------------------
    # checkpoint / restart
    # ------------------------------------------------------------------
    def _checkpoint_after(self, u, previous) -> None:
        prm = self.prm
        if (prm.restart.checkpoint
                and self.control.iteration % prm.restart.frequency == 0):
            self.write_checkpoint(u, previous)

    def write_checkpoint(self, u, previous) -> None:
        """The JAX package's checkpoint: ``<output path>/<filename>.npz``
        with the control and PVD state as JSON, the space's size and
        degree, u and the BDF history (newest first) in the run's dtype,
        and on a forest its leaves and base mesh; written atomically.
        ``u`` None writes the manifest alone: a run over shards keeps the
        fields in per-shard files (``parallel/sharded.py``)."""
        fields = {} if u is None else dict(
            u=u.detach().cpu().numpy(),
            previous=np.stack([p.detach().cpu().numpy() for p in previous]))
        extras = ({} if self.forest is None
                  else forest_checkpoint(self.forest))
        with self.timer.section("checkpoint"):
            write_npz_atomic(
                checkpoint_path(self.prm),
                control=json.dumps(self.control.serialize()),
                pvd=json.dumps(self.pvd.serialize()),
                n_nodes=self.space.n_nodes, degree=self.space.degree,
                **fields, **extras)

    def read_checkpoint(self):
        """Restore the control and PVD state, and a checkpointed forest
        (the mesh and operator are rebuilt on it); returns (u, previous)
        in the run's dtype and device, from a checkpoint of either
        package (float32 or float64), or (None, None) from a manifest
        whose fields are in per-shard files."""
        data = load_checkpoint(checkpoint_path(self.prm))
        if "forest_leaves" in data:
            mesh, self._elem_of, ncf = restore_forest(self.forest, data)
            self.setup(mesh=mesh, nc_faces=ncf)
        if (int(data["n_nodes"]) != self.space.n_nodes
                or int(data["degree"]) != self.space.degree):
            raise ValueError("checkpoint does not match current mesh/space")
        self.control.deserialize(json.loads(str(data["control"])))
        self.pvd.deserialize(json.loads(str(data["pvd"])))
        if "u" not in data:
            return None, None
        kw = dict(dtype=self.dtype, device=self.device)
        return (torch.as_tensor(data["u"], **kw),
                [torch.as_tensor(p, **kw) for p in data["previous"]])

    def _log_newton(self, res, verbose=None):
        if verbose is None:
            verbose = (self.prm.nonlinear_solver.verbosity
                       is Verbosity.verbose and not self.prm.test.enable)
        if not verbose:
            return
        prec = self.prm.simulation_control.log_precision
        for i, r in enumerate(res.res_history):
            if np.isnan(r):
                break
            print(f"Newton iteration: {i:2d}  - Residual:  {r:.{prec}e}")
        per_it = res.host_syncs / max(res.n_iterations, 1)
        print(f"Newton: {res.n_iterations} iterations, "
              f"{res.linear_iters} linear iterations, {res.host_syncs} "
              f"host syncs ({per_it:.1f} per Newton iteration)")

    def l2_errors(self, u, t=0.0):
        if self.exact is None:
            return None
        ev, ep = l2_error(self.op, u, self.exact, t)
        return float(ev), float(ep)
