#!/usr/bin/env python3
"""Newton and Krylov iteration counts of a deck run through the JAX
package, per nonlinear solve and in total (its apps print neither), with
each solve's Newton residual history.

    python3 chip_smoke.py --write-decks DIR && cd DIR &&
    JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=<repo> \\
        python3 <repo>/scripts/jax_newton_counts.py tgv32_gmg.prm 3
    ... python3 <repo>/scripts/jax_newton_counts.py gd_cavity_r8.prm 2 gd

The third argument picks the solver: ``gls`` (the default) or ``gd``.
The deck runs through the solver's own ``solve()``, so what the app
prints (forces, KE and enstrophy) is printed too.  Every nonlinear solve
is counted: a BDF step, each SDIRK stage, a steady solve.  A
pseudo-transient continuation solve (``solver = pseudo_transient``)
prints its pseudo-steps and their Krylov iterations as a ``PTC`` line.
``chip_smoke.py`` holds the PyTorch package's counts against the totals
this prints.

``--pallas-interpret`` runs a GLS deck's operator through the JAX
package's Pallas kernels in interpret mode (``enable_pallas(interpret=
True)``) with the deck's ``jacobian state precision``: how the JAX
package computes a bf16 Jacobian state on a CPU (its CPU path otherwise
ignores the key).  ``chip_smoke.py`` holds the bf16 Taylor-Couette run's
Newton count against the count this prints.

``--frozen-tau`` sets ``stabilization.frozen_tau_jacobian`` (not a deck
key): the Jacobian, and the element matrices of additive Schwarz, with
the stabilization parameter frozen, which is the linearization the
PyTorch package's CUDA kernels compute.

``--centerline`` prints, after the run, the x-velocity of the final GLS
solution on the vertical line x = 0.5 at Ghia, Ghia & Shin's stations
(the lid-driven cavity), read from the nodes on that line: along a mesh
line a Q1 field is linear between its nodes, so the value is exact.
A Kelly deck prints its cells per cycle as the solver's own
``Mesh adaptation`` lines.  ``--l2`` prints the L2 errors of the final
solution against the deck's analytical solution at the final time.

``--shards N`` runs a GLS deck through the JAX package's multi-device
CLI path (``apps/common.py::_run_sharded``, ``ShardedGLSSolver`` over N
devices) and counts its solves; on the CPU the N devices are virtual:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \
        PYTHONPATH=<repo> python3 <repo>/scripts/jax_newton_counts.py \
        mms_q2_r8.prm 2 --shards 4
"""

import sys

import numpy as np

from softx_2020_200_tpu.core.parameters import SimulationParameters


GHIA_Y = (0.0547, 0.0625, 0.0703, 0.1016, 0.1719, 0.2813, 0.4531, 0.5,
          0.6172, 0.7344, 0.8516, 0.9531, 0.9609, 0.9688, 0.9766)


def centerline_u(nodes, u):
    """u_x at x = 0.5 and y = GHIA_Y, from the nodes on the line."""
    on = np.abs(nodes[:, 0] - 0.5) < 1e-9
    order = np.argsort(nodes[on, 1])
    return np.interp(GHIA_Y, nodes[on, 1][order], u[on, 0][order])


def sharded(deck: str, dim: int, shards: int, record, total) -> None:
    """The deck through the JAX CLI over ``shards`` devices, every
    sharded nonlinear solve counted (BDF steps, SDIRK stages, a steady
    solve)."""
    import types

    import jax

    from softx_2020_200_tpu.apps.common import run_app
    from softx_2020_200_tpu.parallel.sharded import ShardedGLSSolver
    if len(jax.devices()) < shards:
        raise SystemExit(f"need {shards} devices, have {len(jax.devices())}")

    def counted(name, pick):
        inner = getattr(ShardedGLSSolver, name)

        def run(self, *args, **kwargs):
            out = inner(self, *args, **kwargs)
            hist, iters, lin = pick(out)
            record(types.SimpleNamespace(
                n_iterations=np.asarray(iters).reshape(-1)[0],
                linear_iters=np.asarray(lin).reshape(-1)[0],
                res_history=np.asarray(hist).reshape(-1, np.shape(hist)[-1])[0]))
            return out

        setattr(ShardedGLSSolver, name, run)

    counted("bdf_step", lambda out: out[2:5])
    counted("solve_local", lambda out: out[1:4])
    counted("solve", lambda out: out[1:4])
    print(f"{shards} devices: {jax.devices()[:shards]}", flush=True)
    run_app(dim, [deck, str(shards)])
    n = max(total["newton"], 1)
    print(f"total: {total['solves']} solves, {total['newton']} Newton, "
          f"{total['krylov']} Krylov iterations, "
          f"{total['krylov'] / n:.2f} per Newton iteration")


def main(deck: str, dim: int, solver: str = "gls",
         pallas_interpret: bool = False, frozen_tau: bool = False,
         centerline: bool = False, l2: bool = False,
         shards: int = 1) -> None:
    if solver == "gd":
        from softx_2020_200_tpu.solvers.gd import GDNavierStokesSolver as cls
    else:
        from softx_2020_200_tpu.solvers.base import \
            GLSNavierStokesSolver as cls
    total = {"solves": 0, "newton": 0, "krylov": 0}

    def record(res, what="Newton"):
        total["solves"] += 1
        total["newton"] += int(res.n_iterations)
        total["krylov"] += int(res.linear_iters)
        hist = np.asarray(res.res_history)
        hist = " ".join(f"{r:.4e}" for r in hist[~np.isnan(hist)])
        print(f"solve {total['solves']}: {int(res.n_iterations)} {what}, "
              f"{int(res.linear_iters)} Krylov iterations, residuals "
              f"{hist}", flush=True)

    newton = cls._newton

    def counted(self, *args, **kwargs):
        res = newton(self, *args, **kwargs)
        record(res)
        return res

    cls._newton = counted
    if shards > 1:
        return sharded(deck, dim, shards, record, total)
    if hasattr(cls, "solve_steady_ptc"):
        ptc = cls.solve_steady_ptc

        def counted_ptc(self, *args, **kwargs):
            res = ptc(self, *args, **kwargs)
            record(res, "PTC steps")
            print(f"PTC: {int(res.n_iterations)} pseudo-steps, "
                  f"{int(res.linear_iters)} Krylov iterations, steady "
                  f"residual {float(res.res_history[int(res.n_iterations)]):.4e}",
                  flush=True)
            return res

        cls.solve_steady_ptc = counted_ptc
    prm = SimulationParameters.from_file(deck, dim=dim)
    if frozen_tau:
        prm.stabilization.frozen_tau_jacobian = True
        print("frozen tau Jacobian", flush=True)
    s = cls(prm)
    if pallas_interpret:
        import jax.numpy as jnp
        bf16 = prm.linear_solver.jacobian_state_precision == "bf16"
        s.op.enable_pallas(interpret=True,
                           state_dtype=jnp.bfloat16 if bf16 else None)
        s._rejit()
        print(f"Pallas kernels in interpret mode, state "
              f"{'bf16' if bf16 else 'full precision'}", flush=True)
    levels = getattr(s, "_mg_levels", None) or getattr(s, "mg_levels", None)
    print(f"preconditioner {s.precond_kind}"
          + (f" ({len(levels)} levels)" if levels else ""), flush=True)
    u = s.solve()
    if centerline:
        vals = centerline_u(np.asarray(s.space.nodes), np.asarray(u))
        print("centerline u: " + " ".join(f"{v:.8e}" for v in vals))
    if l2:
        ev, ep = s.l2_errors(u, s.control.time)
        print(f"final L2 error velocity: {ev:.8e}  pressure: {ep:.8e}")
    n = max(total["newton"], 1)
    print(f"total: {total['solves']} solves, {total['newton']} Newton, "
          f"{total['krylov']} Krylov iterations, "
          f"{total['krylov'] / n:.2f} per Newton iteration")


if __name__ == "__main__":
    flags = ("--pallas-interpret", "--frozen-tau", "--centerline", "--l2")
    argv = sys.argv[1:]
    shards = 1
    if "--shards" in argv:
        i = argv.index("--shards")
        shards = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    args = [a for a in argv if a not in flags]
    main(args[0], int(args[1]), *args[2:3],
         pallas_interpret=flags[0] in argv, frozen_tau=flags[1] in argv,
         centerline=flags[2] in argv, l2=flags[3] in argv, shards=shards)
