#!/usr/bin/env python3
"""Host cost of one call of the kernels B1, B2 and B3 through their
wrappers, against another checkout's, on one NVIDIA GPU.

    python3 scripts/launch_host_cost.py [--parent DIR] [--pairs N]
                                        [--calls N]

At main-path shapes of each kernel (B1: the Taylor-Couette shell at
refinements 3 and 5; B2: the TGV lattice 32^3 and its multigrid level
8^3; B3: the GD cavity's 256^2 and the GD TGV's 16^3) the script times N back-to-back tangent calls (the Krylov matvec's
kernel call: input checks, launch plan, output allocation and launch) on
the host clock and takes microseconds per call, the least of 5 rounds
(other work on the host only adds to a round).  With ``--parent`` it
builds DIR's wrapper of the same kernel on the same tables
(``chip_smoke.load_parent``, a ``git archive`` of the parent commit, say)
and times the two in ``--pairs`` alternating pairs (parent first in even
pairs, second in odd ones), in one process on the same inputs, and
prints each pair and the median difference.  The last line is one JSON
object with every sample.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, kind, dim, degree, cells): the shapes the main path launches
SHAPES = (("B1 2D Q2 Taylor-Couette r3", "element", 2, 2, 3),
          ("B1 2D Q2 Taylor-Couette r5", "element", 2, 2, 5),
          ("B2 3D Q1 8^3 (TGV level 2)", "lattice", 3, 1, (8,) * 3),
          ("B2 3D Q1 TGV 32^3", "lattice", 3, 1, (32,) * 3),
          ("B3 2D Q2-Q1 256^2 (GD cavity)", "gd", 2, 2, (256,) * 2),
          ("B3 3D Q2-Q1 16^3 (GD TGV)", "gd", 3, 2, (16,) * 3))


def _us_per_call(torch, fn, calls: int, rounds: int = 5) -> float:
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return best


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", metavar="DIR",
                        help="another checkout to time against")
    parser.add_argument("--pairs", type=int, default=12)
    parser.add_argument("--calls", type=int, default=200)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("launch_host_cost: needs CUDA", file=sys.stderr)
        return 1
    import chip_smoke as cs
    parent = cs.load_parent(args.parent) if args.parent else None
    device = torch.device("cuda")
    smi = cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"])
    print(f"{torch.cuda.get_device_name(0)}; {smi}")
    results = {}
    for label, kind, dim, degree, cells in SHAPES:
        if kind == "gd":
            op, kernel, _, _, parent_fns = cs._gd_variants(
                torch, dim, cells, True, device, seed=3, parent=parent)
            assert op.layout_v is not None, label
            E = op.space_v.n_elements
        else:
            space = (cs._space(dim, degree, cells, seed=7)
                     if kind == "element"
                     else cs._lattice(dim, degree, cells, periodic=True))
            op, kernel, _, _, parent_fns, _ = cs._variants(
                torch, space, device, seed=3, parent=parent)
            assert (op.layout is not None) == (kind == "lattice"), label
            E = space.n_elements
        fns = {"change": kernel["tangent"]}
        if parent_fns is not None:
            fns["parent"] = parent_fns["tangent"]
        for fn in fns.values():
            fn()
        samples = {name: [] for name in fns}
        for i in range(args.pairs if parent else 1):
            order = ("parent", "change") if i % 2 == 0 else ("change",
                                                             "parent")
            for name in order:
                if name in fns:
                    samples[name].append(_us_per_call(torch, fns[name],
                                                      args.calls))
        results[label] = samples
        if parent is None:
            print(f"  {label:30s} E={E:6d} {samples['change'][0]:8.2f} us "
                  f"per call")
            continue
        deltas = [c - p for c, p in zip(samples["change"],
                                        samples["parent"])]
        for i, (p, c) in enumerate(zip(samples["parent"],
                                       samples["change"])):
            print(f"  {label:30s} E={E:6d} pair {i:2d}: parent {p:7.2f}, "
                  f"change {c:7.2f} us per call")
        print(f"  {label:30s} median parent "
              f"{statistics.median(samples['parent']):.2f}, change "
              f"{statistics.median(samples['change']):.2f}; change - parent "
              f"median {statistics.median(deltas):+.2f} us (min "
              f"{min(deltas):+.2f}, max {max(deltas):+.2f}; change lower in "
              f"{sum(d < 0 for d in deltas)} of {len(deltas)} pairs)")
    print(json.dumps({"us_per_call": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
