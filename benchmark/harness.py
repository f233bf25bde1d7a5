"""One run of one cell: set-up, the measured window, the check, the
result line.

Set-up builds the solver from the cell's deck (``traffic.deck_for``),
runs its first ``warm_steps`` BDF2 steps through the solver's own
transient loop (``run_transient``, the start-up sub-step included) and
keeps every state it returned.  The window repeats one episode of
``episode_steps`` steps (``solve_transient_step``, constant dt, BDF2),
each episode from the state that set-up left, until ``seconds`` have
passed after a completed step.  So every step of every run is the same
work, whatever the speed of the program, and no episode reaches a Kelly
adaptation.  Of the window's steps, the judged ones are the last and
the episode positions drawn from the seed; their states, with the two
before each, are copied to the host as they are produced.

The peak device memory of ``peak_gib`` is read when the first episode
ends: set-up plus ``episode_steps`` steps, the same work whatever the
speed of the program (the solver frees part of its memory only when
Python's cyclic collector runs, so the peak keeps rising with the
episodes a run completes).  After the window: the whole run's peak is
read (``memory_peak_bytes``), the solver freed, and the reference
(``reference/check.py``) judges the set-up's states and the judged
steps.  ``correct`` holds when every number is within its
limit (``limits`` in the cell's file).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from . import traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "softx_2020_200_tpu")


@dataclass
class RunContext:
    """What the metric readers read."""
    steps: int = 0
    window_s: float = 0.0
    plain_window_s: float = 0.0                   # traced steps, untraced
    setup_s: float = 0.0
    peak_bytes: int = 0                           # set-up + one episode
    stats: dict = field(default_factory=dict)     # the window's counts
    trace: object = None                          # trace.TraceSummary


def spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def metric_reader(bench_dir: str, name: str):
    """The module ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, kind: str, workload: str) -> list[str]:
    """The names of the ``kind`` metrics ("end_to_end" or "per_layer")
    that ``workload`` reports."""
    return [m["name"] for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def judged_positions(cell: dict, seed: int) -> list[int]:
    """The episode positions (1-based) judged besides the last step."""
    K = int(cell["episode_steps"])
    n = min(int(cell["judged_steps"]), K)
    pos = traffic.rng(seed, 1).choice(np.arange(1, K + 1), n, replace=False)
    return sorted(int(p) for p in pos)


class Run:
    """One cell on one device: ``setup``, ``window``, ``check``."""

    def __init__(self, cell: dict, seed: int, device: str = "cuda"):
        import torch
        self.torch = torch
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.dim = int(cell["config_data"]["dim"])
        self.deck = self._deck(seed)
        self.dt = float(self.deck["simulation control"]["time step"])

    def _deck(self, seed: int) -> dict:
        """The seed's deck, ending after the warm steps."""
        deck = traffic.deck_for(self.cell, seed)
        sc = deck["simulation control"]
        sc["time end"] = repr(int(self.cell["warm_steps"])
                              * float(sc["time step"]))
        return deck

    # ------------------------------------------------------------------
    def setup(self) -> None:
        """Build the solver and run the warm steps."""
        self.build()
        self.warm()

    def build(self) -> None:
        torch = self.torch
        from softx_2020_200_tpu_torch.core.parameters import \
            SimulationParameters
        from softx_2020_200_tpu_torch.solvers.base import \
            GLSNavierStokesSolver
        prm = SimulationParameters.from_text(traffic.render(self.deck),
                                             self.dim)
        self.solver = GLSNavierStokesSolver(prm, device=self.device,
                                            dtype=torch.float32)
        self.nodes = np.array(self.solver.space.nodes, dtype=np.float64)

    def reseed(self, seed: int) -> None:
        """Another seed's initial field on the built solver, its clock
        from zero (``benchmark/control.py``)."""
        from softx_2020_200_tpu_torch.core.simulation_control import \
            SimulationControl
        self.seed = seed
        self.deck = self._deck(seed)
        s = self.solver
        s.prm.initial_conditions.uvwp = \
            self.deck["initial conditions"]["uvwp"]["Function expression"]
        s.control = SimulationControl(s.prm.simulation_control)

    def warm(self) -> None:
        """The initial field and the warm steps through the solver's own
        loop; keeps the chain of states (host, float32) and the last two
        on the device."""
        torch, s = self.torch, self.solver
        u0 = s.initial_condition()
        chain = [u0]
        step = s.solve_transient_step

        def recorded(*args, **kwargs):
            out = step(*args, **kwargs)
            chain.append(out[0])
            return out

        s.solve_transient_step = recorded
        try:
            s.run_transient(u0=u0, verbose=False)
        finally:
            del s.solve_transient_step
        self.start = (chain[-1], chain[-2])
        self.chain = [u.detach().cpu() for u in chain]
        self.positions = judged_positions(self.cell, self.seed)
        shape = tuple(chain[-1].shape)
        self.buffers = {p: [torch.empty(shape, dtype=torch.float32,
                                        pin_memory=self.cuda)
                            for _ in range(3)] for p in self.positions}
        if self.cuda:
            torch.cuda.synchronize()

    def window(self, seconds: float, max_steps: int | None = None) -> dict:
        """The measured window; returns its steps, wall seconds, the
        solver's counts over it and the device's peak when the first
        episode ended (at the window's end if it never did)."""
        torch, s = self.torch, self.solver
        K = int(self.cell["episode_steps"])
        dts = np.full(3, self.dt)
        t_start = s.control.time
        stats0 = dict(s.stats)
        reached = set()
        steps, episodes, done, peak = 0, 0, False, None
        u3, u2 = self.start
        if self.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        while not done:
            u, prev = u3, [u3, u2, u2]
            for j in range(1, K + 1):
                u, _ = s.solve_transient_step(u, prev, t_start + j * self.dt,
                                              dts, 2, verbose=False)
                prev = [u, prev[0], prev[1]]
                steps += 1
                if j in self.buffers:
                    for buf, state in zip(self.buffers[j], prev):
                        buf.copy_(state, non_blocking=True)
                    reached.add(j)
                if (time.perf_counter() - t0 >= seconds
                        or (max_steps is not None and steps >= max_steps)):
                    done = True
                    break
            episodes += 1
            if self.cuda and episodes == 1 and j == K:
                peak = int(torch.cuda.max_memory_allocated())
            if self.cuda:
                print(f"episode {episodes}: {steps} steps, "
                      f"{time.perf_counter() - t0:.3f} s, allocated "
                      f"{torch.cuda.memory_allocated() / 2 ** 30:.4f} GiB, "
                      f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.4f}"
                      f" GiB", file=sys.stderr)
        if self.cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if self.cuda and peak is None:
            peak = int(torch.cuda.max_memory_allocated())
            print(f"the first episode did not end: the peak is the "
                  f"window's, {steps} of {K} steps", file=sys.stderr)
        # the last step and the two before it go to the host in release()
        self.last = prev
        self.judged = [[b.clone() for b in self.buffers[p]]
                       for p in sorted(reached)]
        stats = {k: s.stats[k] - stats0[k] for k in s.stats}
        return {"steps": steps, "wall_s": wall, "stats": stats,
                "peak_bytes": peak or 0}

    def collect(self) -> None:
        """Move the window's last step and the two before it to the
        host, among the judged states."""
        if self.last is not None:
            self.judged.append([x.detach().cpu() for x in self.last])
            self.last = None

    def release(self) -> None:
        """``collect``, then free the solver and its device memory."""
        self.collect()
        self.solver = self.start = None
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()

    def f32_gap(self) -> float:
        """The reference's float32 evaluation error at the last judged
        step (``benchmark/control.py``'s diagnostic)."""
        from .reference.check import Judge
        judge = Judge(self.deck, self.dim, self.nodes, self.device)
        new, p1, p2 = self.judged[-1]
        return judge.f32_gap(new, [p1, p2], [self.dt, self.dt])

    def check(self, limits: dict, control: bool = False) -> tuple:
        """(numbers, correct) of the reference's judgement; with
        ``control`` every state is first rounded to TF32."""
        from .reference.check import Judge, round_to_tf32
        judge = Judge(self.deck, self.dim, self.nodes, self.device)
        prep = round_to_tf32 if control else (lambda u: u)
        chain = [prep(u) for u in self.chain]
        window = [[prep(u) for u in w] for w in self.judged]
        numbers = judge.judge(chain, window)
        ok = all(name in limits and limits[name] is not None
                 and numbers[name] <= limits[name] for name in numbers)
        return numbers, ok


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (compared whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_name() -> str:
    import torch
    return torch.cuda.get_device_name(0)


def card_line() -> str:
    """The card's name and power limit, from ``nvidia-smi``."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def _traced_window(run, seconds, steps, cuda):
    """``steps`` steps of the window under the profiler and the operator
    call counter: (window, profiler, calls)."""
    from torch.profiler import ProfilerActivity, profile

    from .trace import OperatorCalls
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with OperatorCalls() as calls, profile(activities=activities) as prof:
        w = run.window(seconds, steps)
    return w, prof, calls


def execute(workload: str, seed: int, seconds: float, trace: bool,
            t_process: float, root: str, device: str = "cuda",
            log=sys.stderr) -> dict:
    """One run; returns the result line as a dict (``correct`` false and
    the numbers beside their limits when the check fails).  Raises
    ``SystemExit`` where the contract says the run prints nothing."""
    import torch
    bench_dir = os.path.join(root, "benchmark")
    bench = spec(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = traffic.load_cell(workload, bench_dir)
    cuda = device == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available")
        if torch.cuda.device_count() < int(cells[workload]["chips"]):
            raise SystemExit("fewer CUDA devices than the cell asks for")
        torch.cuda.reset_peak_memory_stats()
    run = Run(cell, seed, device)
    with contextlib.redirect_stdout(log):
        run.setup()
    setup_s = time.perf_counter() - t_process
    print(f"set-up {setup_s:.3f} s", file=log)
    ctx = RunContext(setup_s=setup_s)
    with contextlib.redirect_stdout(log):
        if trace:
            # the traced steps, first without the profiler: the device's
            # idle share is taken against this window's wall time
            plain = run.window(seconds, int(cell["trace_steps"]))
            ctx.plain_window_s = plain["wall_s"]
            w, prof, calls = _traced_window(run, seconds, plain["steps"],
                                            cuda)
        else:
            w = run.window(seconds)
    ctx.steps, ctx.window_s, ctx.stats = w["steps"], w["wall_s"], w["stats"]
    ctx.peak_bytes = w["peak_bytes"]
    run_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    print(f"window: {ctx.steps} steps in {ctx.window_s:.3f} s, Newton "
          f"{ctx.stats['newton_iterations']}, FGMRES "
          f"{ctx.stats['linear_iterations']}, above tolerance "
          f"{ctx.stats['solves_above_tolerance']}; peak {ctx.peak_bytes} B "
          f"after one episode, {run_peak} B in all", file=log)
    if trace:
        from .trace import summarize
        t0 = time.perf_counter()
        ctx.trace = summarize(prof, w["wall_s"])
        ctx.trace.calls = calls.calls
        prof = None
        print(f"trace read in {time.perf_counter() - t0:.3f} s: "
              f"{ctx.trace.n_kernels} kernels, busy {ctx.trace.busy_s:.4f} s "
              f"(untraced window {ctx.plain_window_s:.3f} s)", file=log)
    run.release()
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    units = {m["name"]: m["unit"] for m in bench[kind]}
    for name in metrics_for(bench, kind, workload):
        value = metric_reader(bench_dir, name).read(ctx)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}
    limits = cell["limits"]
    t0 = time.perf_counter()
    numbers, correct = run.check(limits)
    print(f"check {time.perf_counter() - t0:.3f} s", file=log)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: "
                         f"{bad}")
    result = {"correct": bool(correct),
              "attempted": int(ctx.stats["newton_solves"]),
              "failed": int(ctx.stats["solves_above_tolerance"]),
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": card_name() if cuda else "cpu",
                         "count": int(cells[workload]["chips"]),
                         "memory_peak_bytes": run_peak}}
    if trace:
        result["device"]["busy_s"] = ctx.trace.busy_s
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.top_kernels(),
                               "idle_gaps": ctx.trace.idle_gaps}
    result["checks"] = {k: {"value": v, "limit": limits.get(k)}
                        for k, v in numbers.items()}
    if cuda:
        print(f"card: {card_line()}", file=log)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=log)
    return result
