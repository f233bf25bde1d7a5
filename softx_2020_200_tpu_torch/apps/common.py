"""Shared CLI driver for the solver applications::

    python -m softx_2020_200_tpu_torch.apps.gls_navier_stokes_2d deck.prm \
        [n_devices] [--device cuda|cpu] [--dtype float32|float64]

(and ``gls_navier_stokes_3d``, ``gd_navier_stokes_2d``,
``gd_navier_stokes_3d``).  CUDA is the default device, and a run that
asks for CUDA on a host without it fails; it never moves to the CPU by
itself.  ``n_devices`` above 1 shards the solve, the analogue of the
reference's ``mpirun -np N``: with ``--device cuda`` shard p runs on
``cuda:p`` (the run fails when there are fewer cards), with ``--device
cpu`` every shard runs on the CPU.  ``run_app(..., devices=[...])``
places the shards itself (a device may repeat).
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..core.parameters import SimulationParameters, Verbosity
from ..solvers.base import GLSNavierStokesSolver, checkpoint_path
from ..solvers.gd import GDNavierStokesSolver

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
SOLVERS = {"gls": GLSNavierStokesSolver, "gd": GDNavierStokesSolver}


def shard_devices(n: int, device: str | torch.device) -> list:
    """The devices of ``n`` shards on ``device``'s type: every shard on
    the CPU, or shard p on ``cuda:p``."""
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * n
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(f"need {n} devices, have {have} (with --device "
                           "cuda shard p runs on cuda:p)")
    return [torch.device("cuda", p) for p in range(n)]


def run_app(dim: int, argv: list[str] | None = None, *, solver: str = "gls",
            device: str | torch.device | None = None,
            dtype: torch.dtype | None = None, devices: list | None = None
            ) -> int:
    """Parse ``deck.prm [n_devices] [--device] [--dtype]`` and solve with
    the ``solver`` engine (``gls`` or ``gd``).  ``device`` and ``dtype``
    given here override the command line; ``devices`` (one per shard)
    overrides both the device and the count and always shards."""
    parser = argparse.ArgumentParser(prog=f"{solver}_navier_stokes_{dim}d")
    parser.add_argument("deck", help="parameter file (.prm)")
    parser.add_argument("n_devices", nargs="?", type=int, default=1)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--dtype", choices=sorted(_DTYPES),
                        default="float32")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if args.n_devices < 1:
        raise ValueError(f"{args.n_devices} devices")
    device = device if device is not None else args.device
    if devices is None and args.n_devices > 1:
        devices = shard_devices(args.n_devices, device)
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        device = devices[0]
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for and is not available "
                           "(use --device cpu to run on the CPU)")
    dtype = dtype if dtype is not None else _DTYPES[args.dtype]
    prm = SimulationParameters.from_file(args.deck, dim=dim)
    engine = SOLVERS[solver](prm, device=device, dtype=dtype)
    if devices is None:
        engine.solve()
    elif solver == "gls":
        _run_sharded(engine, devices)
    else:
        _run_sharded_gd(engine, devices)
    if not prm.test.enable:
        st = engine.stats
        n = max(st["newton_iterations"], 1)
        print(f"Newton summary: {st['newton_solves']} solves, "
              f"{st['newton_iterations']} iterations, "
              f"{st['linear_iterations']} linear iterations, "
              f"{st['newton_seconds'] / n:.6f} s per Newton iteration, "
              f"{st['host_syncs'] / n:.2f} host syncs per Newton iteration, "
              f"{st['line_search_evaluations']} line-search evaluations, "
              f"{st['linear_restarts']} Krylov restarts, "
              f"{st['solves_above_tolerance']} solves above tolerance")
    return 0


def _run_sharded_gd(s: GDNavierStokesSolver, devices: list) -> None:
    """The GD apps over shards: the engine's orchestration (time loop,
    startup, SDIRK, Kelly, checkpoint/restart, post-processing) runs on
    global state as on one device, and its ``_sharded_hook`` hands every
    nonlinear solve to ``ShardedGDSolver``, which is rebuilt whenever
    an adaptation rebuilds the operator."""
    from ..parallel.sharded_gd import ShardedGDSolver
    cache: dict = {}

    def hook(x0, combo, t, alpha0):
        if cache.get("op") is not s.op:
            cache["op"] = s.op
            cache["sh"] = ShardedGDSolver.from_solver(s, devices)
        return cache["sh"].solve(x0, combo, t=float(t), alpha0=alpha0)

    s._sharded_hook = hook
    s.solve()


def _run_sharded(s: GLSNavierStokesSolver, devices: list) -> None:
    """The GLS apps over shards, as the JAX package's: one steady solve;
    or the time loop on sharded state with BDF startup sub-steps, SDIRK,
    CFL-adaptive dt (the sharded CFL reduction), Kelly adaptation
    (gather, adapt on the host, rebuild the sharded solver on the new
    forest) and checkpoints (the engine's manifest, the fields in
    per-shard files; a restart reads files written under any shard
    count).  Global state is formed only for post-processing, output and
    adaptation."""
    from ..parallel.sharded import ShardedGLSSolver
    sh = ShardedGLSSolver.from_solver(s, devices)
    ctrl, prm = s.control, s.prm
    prec = prm.simulation_control.log_precision
    u0 = s.initial_condition()
    if ctrl.is_steady():
        u, _ = sh.solve(u0)
        if s.exact is not None:
            ev, ep = s.l2_errors(u)
            print(f"L2 error velocity : {ev:.{prec}e}  "
                  f"L2 error pressure: {ep:.{prec}e}")
        s.postprocess(u, 0.0)
        if prm.simulation_control.output_frequency > 0:
            s.write_output(u, 0.0)
        s.write_tables()
        return

    sdirk_order = int(ctrl.method.value[-1]) if ctrl.method.is_sdirk else 0
    target_order = max(ctrl.method.bdf_order, 1)
    if prm.restart.restart:
        # the engine rebuilds itself on a checkpointed forest; the shards
        # are wired against the restored space
        u_g, previous_g = s.read_checkpoint()
        sh = ShardedGLSSolver.from_solver(s, devices)
        if u_g is None:
            u_np, prevs_np = ShardedGLSSolver.read_checkpoint_shards(
                checkpoint_path(prm), sh.layout, s.dtype)
            u = sh.from_stack(u_np)
            prevs = [sh.from_stack(p) for p in prevs_np]
        else:
            u = sh.to_local(u_g)
            prevs = [sh.to_local(p) for p in previous_g]
    else:
        u = sh.to_local(u0)
        prevs = [u, u, u]
    s_scale = prm.simulation_control.startup_timestep_scaling
    startup_left = 0
    if (target_order >= 2 and not sdirk_order and 0.0 < s_scale < 1.0
            and not prm.restart.restart):
        startup_left = target_order - 1
    print_l2 = (s.exact is not None
                and (prm.analytical_solution.verbosity is Verbosity.verbose
                     or prm.test.enable))
    ma = prm.mesh_adaptation

    while not ctrl.is_at_end():
        ctrl.integrate()
        t = ctrl.time
        if not prm.test.enable:
            print(f"*** Time step : {ctrl.iteration}  "
                  f"time = {t:.{prec}g}  dt = {ctrl.dt:.{prec}g} ***")
        if startup_left > 0:
            k = target_order - startup_left
            dt_full = ctrl.dt_history[0]
            dt_a = s_scale * dt_full
            dt_b = dt_full - dt_a
            dts_a = [dt_a] + ctrl.dt_history[1:]
            u, prevs, _ = sh.bdf_step(u, prevs, t - dt_b, dts_a,
                                      min(k, len(dts_a)))
            dts_b = [dt_b, dt_a] + ctrl.dt_history[1:]
            u, prevs, _ = sh.bdf_step(u, prevs, t, dts_b,
                                      min(k + 1, len(dts_b)))
            ctrl.dt_history = ([dt_b, dt_a] + ctrl.dt_history[1:])[:4]
            startup_left -= 1
        elif sdirk_order:
            u, _ = sh.sdirk_step(u, t - ctrl.dt, ctrl.dt, sdirk_order)
            prevs = [u, prevs[0], prevs[1]]
        else:
            u, prevs, _ = sh.bdf_step(u, prevs, t, ctrl.dts(),
                                      ctrl.effective_bdf_order())
        ctrl.cfl = sh.cfl(u, ctrl.dt)
        needs_host = (print_l2 or prm.forces.calculate_forces
                      or prm.forces.calculate_torques
                      or prm.post_processing.calculate_kinetic_energy
                      or prm.post_processing.calculate_enstrophy
                      or ctrl.is_output_iteration())
        if needs_host:
            ug = sh.to_global(u)
            s.postprocess(ug, t)
            if print_l2:
                ev, _ = s.l2_errors(ug, t)
                print(f"L2 error velocity : {ev:.{prec}e}")
            if ctrl.is_output_iteration():
                s.write_output(ug, t)
        # the startup step adapts too, as in the JAX package's sharded
        # loop (its one-device loop does not: on a deck that adapts every
        # step N shards then adapt once more than one device)
        if (ma.type == "kelly" and ma.frequency > 0
                and ctrl.iteration % ma.frequency == 0):
            out = s.refine_mesh_kelly([sh.to_global(v) for v in [u] + prevs])
            sh = ShardedGLSSolver.from_solver(s, devices)
            u = sh.to_local(out[0])
            prevs = [sh.to_local(v) for v in out[1:]]
        if prm.restart.checkpoint and \
                ctrl.iteration % prm.restart.frequency == 0:
            s.write_checkpoint(None, None)
            sh.write_checkpoint_shards(checkpoint_path(prm), u, prevs)
    s.write_tables()
    if prm.timer.type == "end":
        print(s.timer.report())
