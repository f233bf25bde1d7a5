"""What the PyTorch package's drivers (``scripts/run_*_torch.py``) share:
the card's name and power limit, the ``--device`` and ``--dtype`` flags,
the counts since a driver's last progress line, and the ``main`` that
refuses a missing card, prints the card first and one JSON line last.

A driver puts this directory and the repository's root on ``sys.path``
and imports it; so may a caller that imports a driver as a module
(``chip_smoke.py``, the tests)."""

from __future__ import annotations

import json
import subprocess
import sys

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def card() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def add_device_args(parser, dtype: bool = True) -> None:
    """``--device`` (cuda by default) and, with ``dtype``, ``--dtype``."""
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    if dtype:
        parser.add_argument("--dtype", choices=tuple(DTYPES),
                            default="float32")


def peak_gib(cuda: bool):
    """The peak device memory in GiB (None off the card)."""
    return torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None


class Since:
    """The solver's counts since the last ``step`` (the first from 0, or
    from the solver's counts when given): Newton and FGMRES iterations,
    solves above tolerance and multigrid evictions to block-Jacobi."""

    def __init__(self, solver=None):
        self.stats = dict(solver.stats) if solver is not None else None
        self.strikes = 0

    def step(self, solver) -> dict:
        st = solver.stats
        prev = self.stats or {k: 0 for k in st}
        d = {k: st[k] - prev[k] for k in st}
        strikes = solver._gmg_strikes - self.strikes
        self.stats, self.strikes = dict(st), solver._gmg_strikes
        return {"newton": d["newton_iterations"],
                "fgmres": d["linear_iterations"],
                "above_tolerance": d["solves_above_tolerance"],
                "gmg_evictions": strikes,
                "newton_seconds": d["newton_seconds"]}


def main(name: str, parse_args, run, argv=None, drop=("series",)) -> int:
    """Parse ``argv``; without CUDA where ``--device cuda`` (the default)
    asks for it, return 1; otherwise print the card, ``run(args)`` and
    its summary as one JSON line, without the keys of ``drop``."""
    args = parse_args(argv)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print(f"{name}: CUDA is not available (use --device cpu)",
              file=sys.stderr)
        return 1
    print(f"card: {card() if cuda else 'none (cpu)'}", flush=True)
    out = run(args)
    for key in drop:
        out.pop(key)
    out["card"] = card() if cuda else None
    print(json.dumps(out), flush=True)
    return 0
