"""The solver engine: setup, steady/transient stepping, orchestration
(counterpart of ``softx_2020_200_tpu.solvers.base``).

mesh -> DoFs -> constraints -> initial condition -> { steady cycles |
BDF time loop } with post-processing, tables and VTU output.

Everything runs on one device given at construction (``device``,
``dtype``).  A Newton solve is a host loop over device work: each
convergence check reads one number back (see ``solvers/newton.py``), and
the engine keeps the counts in ``self.stats``.
"""

from __future__ import annotations

import os
import time as _time

import numpy as np
import torch

from ..core.bdf import bdf_coefficients
from ..core.expressions import VectorExpression
from ..core.parameters import (BoundaryType, SimulationParameters,
                               TimeSteppingMethod, Verbosity)
from ..core.pvd_handler import PVDHandler
from ..core.simulation_control import SimulationControl
from ..core.timer import SectionTimer
from ..fem.constraints import build_hanging_constraints
from ..fem.dof import FESpace
from ..fem.geometry import det_and_inv
from ..fem.mesh import Manifold, Mesh, generate_mesh
from ..ops.linalg import gmres
from ..ops.operators import assemble
from ..ops.preconditioners import (apply_node_block_state,
                                   build_from_node_blocks,
                                   node_blocks_to_state)
from ..utils.tables import Table
from ..utils.vtu import subcell_connectivity, write_vtu
from . import postprocessing as post
from .analytical import l2_error
from .boundary import BoundaryHandler
from .gls import GLSOperator, StabFlags
from .newton import NewtonConfig, newton_solve


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet "
        f"(ROADMAP.md {item})")


class GLSNavierStokesSolver:
    """Monolithic equal-order GLS solver (GLSNavierStokesSolver<dim>)."""

    def __init__(self, prm: SimulationParameters, mesh: Mesh | None = None,
                 *, device: torch.device | str = "cpu",
                 dtype: torch.dtype = torch.float64):
        self.prm = prm
        self.dim = prm.dim
        self.device = torch.device(device)
        self.dtype = dtype
        if self.device.type == "cuda":
            # f32 means f32: no TF32 in any matrix product
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self._check_supported()
        self.pvd = PVDHandler()
        self.control = SimulationControl(prm.simulation_control)
        self.timer = SectionTimer()
        self.tables: dict[str, list] = {"L2": [], "forces": [], "ke": [],
                                        "enstrophy": []}
        self._force_tables: dict[int, Table] = {}
        self._torque_tables: dict[int, Table] = {}
        self.stats = {"newton_solves": 0, "newton_iterations": 0,
                      "linear_iterations": 0, "host_syncs": 0,
                      "newton_seconds": 0.0}
        self._mesh = mesh
        self.setup()

    # ------------------------------------------------------------------
    def _check_supported(self) -> None:
        prm = self.prm
        if prm.simulation_control.method.is_sdirk:
            raise _not_ported("SDIRK time stepping", "D3")
        if prm.nonlinear_solver.solver == "pseudo_transient":
            raise _not_ported("pseudo-transient continuation", "D3")
        if prm.restart.checkpoint or prm.restart.restart:
            raise _not_ported("checkpoint/restart", "D3")
        if prm.mesh_adaptation.type == "kelly" or prm.mesh.type == "gmsh":
            raise _not_ported("Kelly adaptation, forests and gmsh meshes",
                              "A8, D6")
        pc = prm.linear_solver.preconditioner
        if pc == "gmg":
            raise _not_ported("preconditioner = gmg", "A7, D1")
        if pc == "additive_schwarz":
            raise _not_ported("preconditioner = additive_schwarz", "D4")
        if prm.linear_solver.jacobian_state_precision == "bf16":
            raise _not_ported("jacobian state precision = bf16", "D5")

    def setup(self, mesh: Mesh | None = None) -> None:
        """read_mesh + setup_dofs + operator/BC construction."""
        prm = self.prm
        if mesh is not None:
            self._mesh = mesh
        if self._mesh is None:
            self._mesh = generate_mesh(
                prm.mesh.grid_type, prm.mesh.grid_arguments, dim=self.dim,
                initial_refinement=prm.mesh.initial_refinement)
            for m in prm.manifolds.manifolds:
                center = np.array([float(x) for x in
                                   m.arg.replace(",", " ").split()]
                                  or [0.0] * self.dim)
                self._mesh.boundary_manifolds[m.id] = Manifold(m.type,
                                                               center)
        # periodic declarations reach the mesh before DoF numbering
        for bc in prm.boundary_conditions.bcs:
            if bc.type == BoundaryType.periodic:
                pair = (bc.id, bc.periodic_id, bc.periodic_direction)
                if pair not in self._mesh.periodic:
                    self._mesh.periodic.append(pair)

        kw = dict(dtype=self.dtype, device=self.device)
        self.space = FESpace(self._mesh, prm.fem.velocity_order)
        self.hc = build_hanging_constraints(self.space, []).to(
            self.device, self.dtype)
        stab = StabFlags(
            supg=prm.stabilization.supg,
            pspg=prm.stabilization.pspg,
            gls_viscous_adjoint=prm.stabilization.gls_viscous_adjoint,
            lsic=prm.stabilization.lsic,
            frozen_tau=prm.stabilization.frozen_tau_jacobian)
        self.op = GLSOperator(
            self.space, prm.physical_properties.kinematic_viscosity,
            n_q1d=prm.fem.n_quadrature_points_1d, stab=stab, **kw)
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
        self.precond_kind = ls.preconditioner
        if self.precond_kind == "auto":
            # the JAX package resolves 'auto' to geometric multigrid,
            # which this package does not have yet (ROADMAP A7)
            self.precond_kind = "block_jacobi"
            if not prm.test.enable:
                print("linear solver: preconditioner 'auto' resolves to "
                      "block_jacobi (geometric multigrid is not ported)")
        self._zero_prev = torch.zeros((self.space.n_nodes, self.dim), **kw)

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
            blocks = op.node_blocks(hc.distribute(u), mask, uprev_combo,
                                    fq, alpha0, sdt)
            blocks = bh.slip_project_blocks(blocks)
            return build_from_node_blocks(self.precond_kind, blocks,
                                          mask).apply

        return (constrain, residual, jacobian, node_block_state,
                precond_builder)

    def _newton(self, u0, uprev_combo, t, alpha0, sdt):
        """One nonlinear solve (steady: alpha0 = sdt = 0)."""
        if self.precond_kind not in ("jacobi", "block_jacobi"):
            raise ValueError(
                f"unknown preconditioner {self.precond_kind!r}")
        t0 = _time.perf_counter()
        (constrain, residual, jacobian, node_block_state,
         precond_builder) = self._make_problem(uprev_combo, t, alpha0, sdt)
        u0 = constrain(u0)
        if self.prm.nonlinear_solver.solver == "skip_newton":
            # reference SkipNewtonNonLinearSolver: the preconditioner
            # state is rebuilt every `skip iterations`
            res = newton_solve(residual, jacobian, u0,
                               config=self.newton_cfg,
                               precond_state_fn=node_block_state,
                               precond_apply_fn=apply_node_block_state)
        else:
            res = newton_solve(residual, jacobian, u0,
                               precond_builder=precond_builder,
                               config=self.newton_cfg)
        if self.hc.n:
            res = res._replace(u=self.hc.distribute(res.u))
        st = self.stats
        st["newton_solves"] += 1
        st["newton_iterations"] += res.n_iterations
        st["linear_iterations"] += res.linear_iters
        st["host_syncs"] += res.host_syncs
        st["newton_seconds"] += _time.perf_counter() - t0
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
        x, _, _ = gmres(
            mass_apply, rhs.reshape(-1), precond=lambda v: v / lumped_flat,
            m=50, max_restarts=10,
            atol=1e-10 * float(torch.linalg.vector_norm(rhs)))
        return x.reshape(op.n_nodes, c)

    def solve_steady(self, u0=None, verbose: bool | None = None):
        """One steady nonlinear solve; returns (u, NewtonResult)."""
        if u0 is None:
            u0 = self.initial_condition()
        res = self._newton(u0, self._zero_prev, 0.0, 0.0, 0.0)
        self._log_newton(res, verbose)
        return res.u, res

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

    def run_transient(self, u0=None, on_step=None, verbose=None):
        """Transient BDF time loop, with the JAX package's startup
        sub-stepping: with ``startup time scaling`` s in (0, 1) the first
        step(s) of a BDF2/3 run are split into lower-order sub-steps of
        sizes (s dt, (1-s) dt).  ``on_step(solver, u, t)`` runs after
        every step.  Returns the final solution."""
        ctrl = self.control
        target_order = ctrl.method.bdf_order
        if target_order == 0:
            raise ValueError("run_transient requires a bdf method")
        if u0 is None:
            u0 = self.initial_condition()
        u = u0
        previous = [u0] * 3    # newest first

        prm = self.prm
        s_scale = prm.simulation_control.startup_timestep_scaling
        startup_left = 0
        if target_order >= 2 and 0.0 < s_scale < 1.0:
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
                if on_step is not None:
                    on_step(self, u, t)
                continue
            if (prm.simulation_control.method is not TimeSteppingMethod.steady
                    and not prm.test.enable and verbose is not False):
                prec = prm.simulation_control.log_precision
                print(f"*** Time step : {ctrl.iteration}  "
                      f"time = {t:.{prec}g}  dt = {ctrl.dt:.{prec}g} ***")
            with self.timer.section("solve"):
                u, _ = self.solve_transient_step(
                    u, previous, t, ctrl.dts(), order, verbose=verbose)
            previous = [u] + previous[:2]
            self._after_step(u, t)
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
        """Full orchestration: steady mesh-adaptation cycles (uniform or
        none), each cycle a solve + L2-error table row; transient decks
        delegate to ``run_transient``.  Returns the final solution."""
        prm = self.prm
        if not self.control.is_steady():
            return self.run_transient(on_step=on_cycle)
        n_cycles = prm.simulation_control.number_mesh_adaptation + 1
        u = None
        for cycle in range(n_cycles):
            if cycle > 0:
                if prm.mesh_adaptation.type in ("uniform", "none"):
                    self.setup(self._mesh.refine_uniform(1))
                else:
                    raise ValueError(
                        f"unknown adaptation type "
                        f"{prm.mesh_adaptation.type!r}")
            with self.timer.section("solve"):
                u, _ = self.solve_steady()
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
