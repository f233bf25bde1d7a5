#!/usr/bin/env python3
"""Flow past a sphere, Re = 100 (BASELINE config #5), through the PyTorch
package: ``examples/sphere_re100.prm`` run by the 3D GLS app
(``apps.common.run_app``), steady solves with Kelly adaptation cycles
on the forest, with one line per cycle and one JSON line at the end.

    python scripts/run_sphere_torch.py                   # the deck as written
    python scripts/run_sphere_torch.py --cycles 4        # one cycle further
    python scripts/run_sphere_torch.py --refine 3 --fraction 0.2 \\
        --max-elements 2600000 --cycles 4                # the flagship ladder
    python scripts/run_sphere_torch.py --refine 0 --cycles 1 --device cpu

The flags replace the deck's initial refinement, number of adaptation
cycles, element budget and refinement fraction; field output is off.
Each cycle prints its cells and DoF, the solve's Newton and FGMRES
iterations and final residual, the multigrid evictions to block-Jacobi
(``GMG stagnated``), seconds per Newton iteration, the host seconds of
the adaptation before the solve (timer sections ``kelly_estimate``,
``refine``, ``setup``, ``transfer``), the peak device memory and the
force on the sphere (boundary 3) with Cd = 8 F_x / pi (U = 1, D = 1);
on the card also the largest device tensors the engine holds, by
owner, and the flexible Krylov basis (V and Z) of one restart cycle.
The card's name and power limit are printed first; the run is float32
(the app's default).
"""

from __future__ import annotations

import argparse
import math
import os
import re
import sys
import tempfile
import time

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(SCRIPTS)
sys.path[:0] = [ROOT, SCRIPTS]

import torch  # noqa: E402

import torch_driver  # noqa: E402
from softx_2020_200_tpu_torch.apps import common  # noqa: E402
from softx_2020_200_tpu_torch.solvers import \
    postprocessing as post  # noqa: E402

DECK = os.path.join(ROOT, "examples", "sphere_re100.prm")
ADAPT_SECTIONS = ("kelly_estimate", "refine", "setup", "transfer")
SPHERE = 3


def deck_text(args) -> str:
    """The deck with the flags' values in place of its own."""
    text = open(DECK).read()
    edits = {"output frequency": 0}
    for key, value in (("initial refinement", args.refine),
                       ("number mesh adapt", args.cycles),
                       ("max number elements", args.max_elements),
                       ("fraction refinement", args.fraction)):
        if value is not None:
            edits[key] = value
    for key, value in edits.items():
        text, n = re.subn(rf"(set {key}\s*=).*", rf"\g<1> {value}", text)
        if n != 1:
            raise ValueError(f"deck key {key!r} found {n} times")
    return text


def device_tensors(engine) -> dict:
    """Bytes of the device tensors reachable from the engine (its
    operator's buffers, kernel rows, multigrid levels and what their
    closures hold), by the first attribute path that reaches each."""
    seen, out = set(), {}

    def walk(obj, path, depth):
        if isinstance(obj, torch.Tensor):
            if obj.device.type == "cuda":
                key = obj.untyped_storage().data_ptr()
                if key not in seen:
                    seen.add(key)
                    out[path] = obj.untyped_storage().nbytes()
            return
        if depth == 0 or id(obj) in seen or isinstance(
                obj, (str, bytes, int, float, bool, type(None))):
            return
        seen.add(id(obj))
        if isinstance(obj, dict):
            items = [(str(k), v) for k, v in obj.items()]
        elif isinstance(obj, (list, tuple)):
            items = [(str(i), v) for i, v in enumerate(obj)]
        elif callable(obj) and getattr(obj, "__closure__", None):
            items = [(n, c.cell_contents) for n, c in zip(
                obj.__code__.co_freevars, obj.__closure__)
                if c.cell_contents is not None]
        elif hasattr(obj, "__dict__"):
            items = list(vars(obj).items())
        else:
            return
        for name, value in items:
            walk(value, f"{path}.{name}", depth - 1)

    walk(engine, "engine", 8)
    return out


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--refine", type=int, help="initial refinement "
                        "(the deck's: 2)")
    parser.add_argument("--cycles", type=int, help="Kelly adaptation "
                        "cycles (the deck's: 3)")
    parser.add_argument("--max-elements", type=int, help="element budget "
                        "(the deck's: 400000)")
    parser.add_argument("--fraction", type=float, help="Kelly refinement "
                        "fraction (the deck's: 0.15)")
    torch_driver.add_device_args(parser, dtype=False)
    return parser.parse_args(argv)


def run(args) -> dict:
    """The deck through the 3D GLS app with a line per cycle; returns the
    summary (the rows of the cycles under ``cycles``)."""
    cuda = args.device == "cuda"
    rows, last = [], {"sections": {}, "t": time.perf_counter()}
    since = torch_driver.Since()
    residuals = []
    t0 = time.perf_counter()

    def on_cycle(engine, u, t):
        d = since.step(engine)
        sections = {k: v[0] for k, v in engine.timer.sections.items()}
        adapt = {k: sections.get(k, 0.0) - last["sections"].get(k, 0.0)
                 for k in ADAPT_SECTIONS}
        last["sections"] = sections
        f = post.forces_on_boundary(engine.op, u,
                                    engine.space.boundary_faces[SPHERE])
        f = [float(x) for x in f.cpu()]
        peak = torch_driver.peak_gib(cuda)
        n = max(d["newton"], 1)
        row = {"cycle": len(rows), "cells": engine.space.n_elements,
               "dofs": engine.space.n_dofs(engine.dim + 1),
               "newton": d["newton"], "fgmres": d["fgmres"],
               "final_residual": residuals[-1] if residuals else None,
               "above_tolerance": d["above_tolerance"],
               "gmg_evictions": d["gmg_evictions"],
               "preconditioner": engine.precond_kind,
               "s_per_newton": d["newton_seconds"] / n,
               "adapt_s": adapt, "peak_gib": peak, "force": f,
               "Cd": 8.0 * f[0] / math.pi,
               "cycle_s": time.perf_counter() - last["t"],
               "wall_s": time.perf_counter() - t0}
        rows.append(row)
        print(f"cycle {row['cycle']}: cells {row['cells']} dofs "
              f"{row['dofs']} newton {row['newton']} fgmres {row['fgmres']} "
              f"final residual {row['final_residual']:.4e} evictions "
              f"{d['gmg_evictions']} ({row['preconditioner']}) s/newton "
              f"{row['s_per_newton']:.4f} adapt "
              + " ".join(f"{k} {v:.2f}" for k, v in adapt.items())
              + (f" peak {peak:.3f} GiB" if peak is not None else "")
              + f" force {f[0]:.6e} {f[1]:.6e} {f[2]:.6e} Cd "
              f"{row['Cd']:.5f} cycle {row['cycle_s']:.1f} s wall "
              f"{row['wall_s']:.1f} s", flush=True)
        if cuda:
            sizes = sorted(device_tensors(engine).items(),
                           key=lambda kv: -kv[1])
            m = engine.newton_cfg.gmres_restart
            n_dof = engine.space.n_nodes * (engine.dim + 1)
            item = torch.finfo(engine.dtype).bits // 8
            basis = (2 * m + 1) * n_dof * item
            print(f"  memory: Krylov basis V+Z ({2 * m + 1} x {n_dof}) "
                  f"{basis / 2 ** 20:.1f} MiB; engine tensors "
                  f"{sum(s for _, s in sizes) / 2 ** 20:.1f} MiB in "
                  f"{len(sizes)}; largest: " + ", ".join(
                      f"{p[7:]} {s / 2 ** 20:.1f}" for p, s in sizes[:12]),
                  flush=True)
            torch.cuda.reset_peak_memory_stats()
        last["t"] = time.perf_counter()

    engine_cls = common.SOLVERS["gls"]

    class Engine(engine_cls):
        """The GLS engine with ``on_cycle`` after each cycle and each
        solve's final residual recorded."""

        def solve(self):
            return super().solve(on_cycle=on_cycle)

        def _newton(self, *a, **k):
            res = super()._newton(*a, **k)
            residuals.append(float(res.res_history[res.n_iterations]))
            return res

    common.SOLVERS["gls"] = Engine
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "sphere.prm")
            with open(path, "w") as fh:
                fh.write(deck_text(args))
            cwd = os.getcwd()
            os.chdir(tmp)
            try:
                common.run_app(3, [path, "--device", args.device])
            finally:
                os.chdir(cwd)
    finally:
        common.SOLVERS["gls"] = engine_cls
    return {"case": "sphere_re100_steady_kelly", "flags": vars(args),
            "cycles": rows, "Cd_final": rows[-1]["Cd"] if rows else None,
            "wall_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    return torch_driver.main("run_sphere_torch", parse_args, run, argv,
                             drop=())


if __name__ == "__main__":
    sys.exit(main())
