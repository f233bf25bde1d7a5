#!/usr/bin/env python3
"""Which floor a float32 convergence ladder meets: float32's arithmetic,
or its stopping criteria.  Runs levels of ``scripts/run_convergence_torch.py``
in float64 with the float32 runs' stopping criteria (Newton to
``F32_TOLERANCE``, each linear solve to ``F32_MIN_RESIDUAL``) instead of
the decks' own.  Where this run lands on the float32 run's error, the
floor is the criteria's; where it lands on the float64 witness, it is
float32's.

    python scripts/stopping_floor_control.py bdf3     # 4^2, dt 0.1 to 0.00625
    python scripts/stopping_floor_control.py q2 128^2 gd 128^2

A transient ladder runs whole at refinement 2; a spatial one runs the
named level as its own deck.  On the CPU, one table line per level.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run_convergence_torch as conv  # noqa: E402


def _prm(text: str, args, key: str):
    prm = _deck_prm(text, args, key)
    prm.nonlinear_solver.tolerance = conv.F32_TOLERANCE[key]
    prm.linear_solver.minimum_residual = conv.F32_MIN_RESIDUAL[key]
    return prm


_deck_prm, conv._prm = conv._prm, _prm


def main(argv: list[str]) -> int:
    it = iter(argv)
    for name in it:
        args = conv.parse_args(["--ladders", name, "--device", "cpu",
                                "--dtype", "float64", "--time-refines", "2"])
        if name in conv.TEMPORAL:
            todo = conv.levels(name, args)
        else:
            label = next(it)
            todo = [dict(lv) for lv in conv.levels(name, args, cycles=0)
                    if lv["label"] == label][-1:]
            todo[0].pop("repeats", None)
        conv.run_ladder(name, args, emit=lambda s: print(s, flush=True),
                        todo=todo)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
