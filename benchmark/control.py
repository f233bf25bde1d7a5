#!/usr/bin/env python3
"""The control of a cell's check, at the cell's own size, on the card.

    python3 benchmark/control.py --workload tgv_re1600_q1.n96 \\
        --seeds 11,12,13 --seconds 20

Builds the cell's solver once, then for each seed: the seed's initial
field, the warm steps, a window of ``--seconds`` (at least one step), and
the reference's numbers twice: of the states the solver returned (the
program's readings, which set a limit's lower end) and of the same
states rounded to TF32 (the control: the answer of a float32 solve
computed a step lower, which has to fail).  Beside them, the size of
the float32 evaluation error of the residual at the last judged state
(the reference run in float32 against float64): how far below the
deck's tolerance a float32 solver can know its residual.  Prints one
JSON line per seed, then a summary: the largest program reading and the smallest
control reading of each number, whether every program run is within
the cell's limits and whether every control run fails one of them.
The benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True,
                        help="comma-separated whole numbers")
    parser.add_argument("--seconds", type=float, default=10.0)
    args = parser.parse_args(argv)
    import torch
    from benchmark import harness, traffic
    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 2
    cell = traffic.load_cell(args.workload)
    limits = cell["limits"]
    seeds = [int(s) for s in args.seeds.split(",")]
    run = harness.Run(cell, seeds[0])
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        run.build()
    print(f"build {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    program, control = {}, {}
    passes = fails = True
    for seed in seeds:
        with contextlib.redirect_stdout(sys.stderr):
            run.reseed(seed)
            run.warm()
            w = run.window(args.seconds)
            run.collect()
        ours, ok = run.check(limits)
        gap = run.f32_gap()
        low, bad = run.check(limits, control=True)
        passes &= ok
        fails &= not bad
        for k, v in ours.items():
            program[k] = max(program.get(k, 0.0), v)
        for k, v in low.items():
            control[k] = min(control.get(k, float("inf")), v)
        print(json.dumps({"seed": seed, "steps": w["steps"],
                          "step_s": w["wall_s"] / w["steps"],
                          "newton": w["stats"]["newton_iterations"],
                          "fgmres": w["stats"]["linear_iterations"],
                          "failed": w["stats"]["solves_above_tolerance"],
                          "program": ours, "program_ok": ok,
                          "f32_residual_error": gap,
                          "control": low, "control_ok": bad}), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": seeds,
                      "limits": limits, "program_max": program,
                      "control_min": control, "program_passes": passes,
                      "control_fails": fails}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
