#!/usr/bin/env python3
"""Where the time goes in one deck of the PyTorch package on the GPU.

    python3 scripts/profile_torch_deck.py DECK [DECK ...]

Each DECK is a name from ``chip_smoke.DECKS`` (for example
``tgv32_3steps.prm``; a name with a ``gd`` part, such as
``gd_cavity_r8.prm``, runs through the GD app).  For each: one run
through the app to build and
warm up, one timed run (host clock, ending in a synchronise), then one
run under ``torch.profiler``.  Prints the wall of the timed run, the
kernel time the profiler saw and its share of that wall (the device's
busy share; the profiler itself slows the host, not the kernels), the
launches per CUDA kernel wrapper, the top kernels by device time and the
top host operations.  Needs CUDA.
"""

from __future__ import annotations

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
    avgs = prof.key_averages()
    kernels = [a for a in avgs if _is_kernel(a)]
    device_us = sum(_self_device_us(a) for a in kernels)
    print(f"== {deck}: wall {wall:.4f} s, kernel time {device_us / 1e6:.4f}"
          f" s in {sum(a.count for a in kernels)} kernels, busy share "
          f"{device_us / 1e6 / wall:.3f}, launches {launches}")
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
    decks = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("profile_torch_deck: needs CUDA", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    for deck in decks:
        profile(deck)
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
