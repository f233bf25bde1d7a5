#!/usr/bin/env python3
"""Where the time goes in one deck of the PyTorch package on the GPU.

    python3 scripts/profile_torch_deck.py DECK [DECK ...]
    python3 scripts/profile_torch_deck.py --tgv 96 [--warm 2] [--steps 20]
    python3 scripts/profile_torch_deck.py --cell tgv_re1600_q1.n96 \
        [--seed S] [--steps K]

Each DECK is a name from ``chip_smoke.DECKS`` (for example
``tgv32_3steps.prm``; a name with a ``gd`` part, such as
``gd_cavity_r8.prm``, runs through the GD app).  For each: one run
through the app to build and
warm up, one timed run (host clock, ending in a synchronise), then one
run under ``torch.profiler``.  ``--tgv N`` profiles steps of the TGV
driver (``scripts/run_tgv_torch.py``) at N^3 instead, in one run of
``--warm`` + 2 ``--steps`` BDF2 steps: after the warm steps a timed
window of ``--steps`` steps, then a window of as many under the
profiler, each from a synchronise to a synchronise and each with its
launch counts (each step with the driver's KE and dissipation reads);
the solver's setup, the BDF2 startup and the kernels' first use lie
outside both.  ``--cell NAME`` profiles a cell of the benchmark
(``benchmark/workloads/NAME.json``) as its traced run does: the cell's
set-up for ``--seed``, ``--steps`` steps (the cell's ``trace_steps``
by default) timed, then as many under the profiler; it also prints
the set-up's timer sections (``setup_mesh``, ``setup_space``,
``setup_operator``, ``setup_levels``) and, beside the lattice kernel's
degree-2 launches in the traced steps, the kernels whose names
``b2_q2_roofline`` reads as that kernel's degree-2 instances (the two
counts are equal where the metric's name patterns catch every launch
and no other kernel).  Prints the wall
of the timed run or window, the kernel time the profiler saw and its
share of that wall (the device's busy share; the profiler itself slows
the host, not the kernels), the launches per CUDA kernel wrapper, the
top kernels by device time and the top host operations (not for
``--cell``), then the program's spans (``core/spans.py``): device
seconds and kernels under each innermost span, by multigrid level, by
level and gather site and for the CGS2 orthogonalisation, the device's
longest idle time by the span the host was in, and the spans per step.
The spans are read from the profiler's raw events, as
``benchmark/trace.py`` reads them.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import io
import os
import re
import sys
import tempfile
import time
from collections import Counter, defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _self_device_us(avg) -> float:
    t = getattr(avg, "self_device_time_total", None)
    return float(t if t is not None else avg.self_cuda_time_total)


def _is_kernel(avg) -> bool:
    from torch.autograd import DeviceType
    return avg.device_type == DeviceType.CUDA


def profile(deck: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity
    import chip_smoke
    from softx_2020_200_tpu_torch.apps.common import run_app

    dim = 3 if "tgv" in deck or "sphere" in deck else 2
    solver = "gd" if "gd" in deck[:-len(".prm")].split("_") else "gls"
    counters = chip_smoke._launch_counters()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, deck)
        with open(path, "w") as fh:
            fh.write(chip_smoke.deck_text(deck))
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            def once():
                with contextlib.redirect_stdout(io.StringIO()):
                    run_app(dim, [path], solver=solver, device="cuda",
                            dtype=torch.float32)
                torch.cuda.synchronize()

            once()
            for cls in counters.values():
                cls.launches = 0
            t0 = time.perf_counter()
            once()
            wall = time.perf_counter() - t0
            launches = {name: cls.launches for name, cls in counters.items()}
            with torch.profiler.profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                once()
        finally:
            os.chdir(cwd)
    report(deck, wall, prof, launches)


def profile_tgv(n: int, warm: int, steps: int) -> None:
    """The TGV driver at n^3 (dt 0.02): steps ``warm`` + 1 .. ``warm`` +
    ``steps`` under the host clock and the launch counters, the next
    ``steps`` under the profiler and the launch counters too."""
    import torch
    from torch.profiler import ProfilerActivity
    import chip_smoke
    import run_tgv_torch as tgv

    counters = chip_smoke._launch_counters()
    prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
    walls, launches, marks = [], [], (warm, warm + steps, warm + 2 * steps)

    def hook(step):
        if step not in marks:
            return
        torch.cuda.synchronize()
        if step != warm:
            walls.append(time.perf_counter() - t0[0])
            launches.append({name: cls.launches
                             for name, cls in counters.items()})
        if step == warm + steps:
            prof.start()
        elif step == marks[-1]:
            prof.stop()
        for cls in counters.values():
            cls.launches = 0
        t0[0] = time.perf_counter()

    t0 = [0.0]
    with tempfile.TemporaryDirectory() as tmp:
        args = tgv.parse_args(["--n", str(n), "--t-end",
                               repr(0.02 * marks[-1]), "--out",
                               os.path.join(tmp, "series.dat")])
        with contextlib.redirect_stdout(io.StringIO()):
            res = tgv.run(args, step_hook=hook)
    if len(walls) != 2:
        raise RuntimeError(f"the TGV run took {res['steps']} steps, not "
                           f"{marks[-1]}")
    print(f"== TGV {n}^3 under the profiler, steps {marks[1] + 1}-"
          f"{marks[2]}: wall {walls[1]:.4f} s, launches {launches[1]}")
    report(f"TGV {n}^3, steps {marks[0] + 1}-{marks[1]} timed (the kernel "
           "time from the profiled window)", walls[0], prof, launches[0])


def report(label: str, wall: float, prof, launches: dict) -> None:
    avgs = prof.key_averages()
    kernels = [a for a in avgs if _is_kernel(a)]
    device_us = sum(_self_device_us(a) for a in kernels)
    print(f"== {label}: wall {wall:.4f} s, kernel time "
          f"{device_us / 1e6:.4f} s in {sum(a.count for a in kernels)} "
          f"kernels, busy share {device_us / 1e6 / wall:.3f}, launches "
          f"{launches}")
    rows = sorted(kernels, key=_self_device_us, reverse=True)[:15]
    print(f"  {'kernels by device time':60s} {'calls':>8s} "
          f"{'device ms':>10s}")
    for a in rows:
        print(f"  {a.key[:60]:60s} {a.count:8d} "
              f"{_self_device_us(a) / 1e3:10.3f}")
    rows = sorted((a for a in avgs if not _is_kernel(a)),
                  key=lambda a: a.self_cpu_time_total, reverse=True)[:10]
    print(f"  {'by host time (under the profiler)':60s} {'calls':>8s} "
          f"{'host ms':>10s}")
    for a in rows:
        print(f"  {a.key[:60]:60s} {a.count:8d} "
              f"{a.self_cpu_time_total / 1e3:10.3f}")
    span_report(prof)


# the program's span names (``core/spans.py``)
SPAN = re.compile(r"^(step|sync|(newton|krylov|gmg|op|gather)\.[\w.]+)$")
LEVEL = re.compile(r"^gmg\.(L\d+)\.")


def _nest(spans):
    """The parent of each span (an index, -1 at the top), spans sorted
    by start and properly nested, as on one thread."""
    parent, stack = [], []
    for start, end, _ in spans:
        while stack and spans[stack[-1]][1] < start:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(len(parent) - 1)
    return parent


def _innermost(spans, parent, times):
    """The index of the innermost span around each time (-1: none)."""
    starts = [s for s, _, _ in spans]
    out = []
    for t in times:
        k = bisect.bisect_right(starts, t) - 1
        while k >= 0 and spans[k][1] < t:
            k = parent[k]
        out.append(k)
    return out


def _chain(k, spans, parent):
    names = []
    while k >= 0:
        names.append(spans[k][2])
        k = parent[k]
    return names                        # innermost first


def _level(chain):
    """The multigrid level ('L<k>') a span chain lies in, or None."""
    return next((LEVEL.match(c).group(1) for c in chain if LEVEL.match(c)),
                None)


def _label(chain, level):
    """'level: parent > innermost' of a span chain (innermost first)."""
    if not chain:
        return "(no span)"
    return f"{level or '-'}: " + " > ".join(reversed(chain[:2]))


def _table(title, rows, n=25):
    """rows: {key: [kernels, seconds]}, printed by seconds."""
    print(f"  {title:60s} {'kernels':>8s} {'device ms':>10s}")
    for key, (k, sec) in sorted(rows.items(), key=lambda kv: -kv[1][1])[:n]:
        print(f"  {key[:60]:60s} {k:8d} {sec * 1e3:10.3f}")


def span_report(prof, n_gaps: int = 12) -> None:
    """The device's kernels and idle time under the program's spans:
    each kernel goes to the innermost span around the host operation
    that launched it (matched by correlation id), each idle gap to the
    innermost span around its middle."""
    from torch.autograd import DeviceType

    # the index-gather kernels, as ``gather_share`` names them
    from benchmark.metrics.gather_share import PATTERNS
    spans, kernels, launched_at = [], [], {}
    for ev in prof.profiler.kineto_results.events():
        start, dur = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            kernels.append((ev.linked_correlation_id(), start, start + dur,
                            ev.name()))
        else:
            launched_at[ev.correlation_id()] = start
            if SPAN.match(ev.name()):
                spans.append((start, start + dur, ev.name()))
    if not spans:
        print("  no program spans in the trace")
        return
    spans.sort(key=lambda sp: (sp[0], -sp[1]))
    parent = _nest(spans)
    # a kernel is linked to the host op around its launch: a torch
    # operation, or for a ctypes launch the span itself
    at = [launched_at.get(corr, -1) for corr, _, _, _ in kernels]
    where = _innermost(spans, parent, at)
    by_span, by_level, by_site, cgs2 = (defaultdict(lambda: [0, 0.0])
                                        for _ in range(4))
    by_name = defaultdict(lambda: defaultdict(lambda: [0, 0.0]))
    for (corr, s0, s1, name), k in zip(kernels, where):
        sec = (s1 - s0) * 1e-9
        chain = _chain(k, spans, parent)
        level = _level(chain)
        key = _label(chain, level)
        for table, key_ in ((by_span, key),
                            (by_level, level or "outside the levels"),
                            (by_name[name], key)):
            table[key_][0] += 1
            table[key_][1] += sec
        if any(p in name for p in PATTERNS):
            site = next((c for c in chain if c.startswith("gather.")),
                        "(an index kernel outside gather spans)")
            by_site[f"{level or '-'}: {site}"][0] += 1
            by_site[f"{level or '-'}: {site}"][1] += sec
        if "krylov.orthogonalize" in chain:
            i = chain.index("krylov.orthogonalize")
            caller = chain[i + 1] if i + 1 < len(chain) else ""
            cgs2[f"{level or '-'}: {caller}"][0] += 1
            cgs2[f"{level or '-'}: {caller}"][1] += sec
    steps = sum(1 for sp in spans if sp[2] == "step")
    print(f"== program spans: {len(spans)} in {steps} steps "
          f"({len(spans) / max(steps, 1):.1f} per step), {len(kernels)} "
          f"device events")
    _table("innermost span (level: its parent >)", by_span)
    names = sorted(by_name.items(), key=lambda kv: -sum(
        sec for _, sec in kv[1].values()))[:10]
    print("  the ten kernels with the most device time, by launching span")
    for name, rows in names:
        total = sum(sec for _, sec in rows.values())
        print(f"  {name[:100]} {total * 1e3:.3f} ms")
        _table("  launched under", dict(sorted(
            rows.items(), key=lambda kv: -kv[1][1])[:3]), 3)
    _table("multigrid level", by_level)
    _table("level: gather site (index-gather kernels)", by_site)
    _table("CGS2 (krylov.orthogonalize) by caller", cgs2)
    # idle gaps of the device by the span the host was in
    dev = sorted((s0, s1) for _, s0, s1, _ in kernels)
    busy = []
    for s0, s1 in dev:
        if busy and s0 <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], s1)
        else:
            busy.append([s0, s1])
    gaps = [(b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:])]
    mids = [(g0 + g1) // 2 for g0, g1 in gaps]
    idle = Counter()
    for (g0, g1), k in zip(gaps, _innermost(spans, parent, mids)):
        chain = _chain(k, spans, parent)
        idle[_label(chain, _level(chain))] += (g1 - g0) * 1e-9
    print(f"  {'device idle, by the host span around the gap':60s} "
          f"{'idle ms':>19s}")
    for label, sec in idle.most_common(n_gaps):
        print(f"  {label[:60]:60s} {sec * 1e3:19.3f}")
    host = defaultdict(lambda: [0, 0.0])
    for s0, s1, name in spans:
        host[name][0] += 1
        host[name][1] += (s1 - s0) * 1e-9
    print(f"  {'host time by span (calls, host ms, all nested)':60s}")
    for name, (n, sec) in sorted(host.items(), key=lambda kv: -kv[1][1]):
        print(f"  {name[:60]:60s} {n:8d} {sec * 1e3:10.3f}")


def profile_cell(name: str, seed: int, steps: int | None) -> None:
    """A benchmark cell's set-up, then ``steps`` steps of its window
    timed and as many under the profiler, as its traced run does."""
    import torch
    from torch.profiler import ProfilerActivity

    from benchmark import harness, traffic
    from benchmark.metrics.b2_q2_roofline import PATTERNS as Q2_PATTERNS
    from softx_2020_200_tpu_torch.ops.lattice_kernel import LatticeGLSKernel
    cell = traffic.load_cell(name, os.path.join(ROOT, "benchmark"))
    steps = steps or int(cell["trace_steps"])
    run = harness.Run(cell, seed)
    with contextlib.redirect_stdout(io.StringIO()):
        run.setup()
        plain = run.window(1e9, steps)
        before = dict(LatticeGLSKernel.launches_by_shape)
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced = run.window(1e9, steps)
    q2_launches = sum(n - before.get(key, 0) for key, n in
                      LatticeGLSKernel.launches_by_shape.items()
                      if key[1] == 2)
    q2_kernels = sum(
        1 for ev in prof.profiler.kineto_results.events()
        if ev.device_type() == torch.autograd.DeviceType.CUDA
        and any(p in ev.name() for p in Q2_PATTERNS))
    st = traced["stats"]
    sections = run.solver.timer.sections
    print(f"== {name} set-up sections (host s): " + ", ".join(
        f"{k} {t:.3f}" for k, (t, _) in sections.items()
        if k.startswith("setup_")))
    print(f"== {name}, seed {seed}: {steps} steps, wall {plain['wall_s']:.4f}"
          f" s, under the profiler {traced['wall_s']:.4f} s; Newton "
          f"{st['newton_iterations']}, FGMRES {st['linear_iterations']}, "
          f"V-cycles {st['vcycles']}, host syncs {st['host_syncs']}")
    print("  counters: " + ", ".join(
        f"{k} {st[k]}" for k in st if k.startswith("gather_")
        or k in ("vcycle_s", "sync_wait_s", "newton_seconds")))
    print(f"  lattice kernel, degree 2: {q2_launches} launches, "
          f"{q2_kernels} kernels under b2_q2_roofline's name patterns")
    span_report(prof)
    run.release()


def main(argv=None) -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("decks", nargs="*")
    parser.add_argument("--tgv", type=int, help="profile the TGV driver "
                        "at this many cells per axis")
    parser.add_argument("--warm", type=int, default=2,
                        help="TGV steps before the window")
    parser.add_argument("--steps", type=int, default=None,
                        help="steps in the window (TGV: 20; a cell: its "
                        "trace_steps)")
    parser.add_argument("--cell", help="profile this cell of the "
                        "benchmark")
    parser.add_argument("--seed", type=int, default=1,
                        help="the cell's seed")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_deck: needs CUDA", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    torch.backends.cuda.matmul.allow_tf32 = False
    for deck in args.decks:
        profile(deck)
        sys.stdout.flush()
    if args.tgv:
        profile_tgv(args.tgv, args.warm, args.steps or 20)
    if args.cell:
        profile_cell(args.cell, args.seed, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
