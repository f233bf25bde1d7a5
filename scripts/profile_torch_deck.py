#!/usr/bin/env python3
"""Where the time goes in one deck of the PyTorch package on the GPU.

    python3 scripts/profile_torch_deck.py DECK [DECK ...]
    python3 scripts/profile_torch_deck.py --tgv 96 [--warm 2] [--steps 20]

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
outside both.  Prints the wall of the timed run or window, the kernel
time the profiler saw and its share of that wall (the device's busy
share; the profiler itself slows the host, not the kernels), the
launches per CUDA kernel wrapper, the top kernels by device time and
the top host operations.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import tempfile
import time

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


def main(argv=None) -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("decks", nargs="*")
    parser.add_argument("--tgv", type=int, help="profile the TGV driver "
                        "at this many cells per axis")
    parser.add_argument("--warm", type=int, default=2,
                        help="TGV steps before the window")
    parser.add_argument("--steps", type=int, default=20,
                        help="TGV steps in the window")
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
        profile_tgv(args.tgv, args.warm, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
