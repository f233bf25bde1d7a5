"""Shared CLI driver for the solver applications::

    python -m softx_2020_200_tpu_torch.apps.gls_navier_stokes_2d deck.prm \
        [--device cuda|cpu] [--dtype float32|float64]

One device per run: an ``n_devices`` argument above 1 raises (the
multi-device path is ROADMAP A10).  CUDA is the default device, and a
run that asks for CUDA on a host without it fails; it never moves to
the CPU by itself.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..core.parameters import SimulationParameters
from ..solvers.base import GLSNavierStokesSolver

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def run_app(dim: int, argv: list[str] | None = None, *,
            device: str | torch.device | None = None,
            dtype: torch.dtype | None = None) -> int:
    """Parse ``deck.prm [n_devices] [--device] [--dtype]`` and solve.
    ``device`` and ``dtype`` given here override the command line."""
    parser = argparse.ArgumentParser(prog=f"gls_navier_stokes_{dim}d")
    parser.add_argument("deck", help="parameter file (.prm)")
    parser.add_argument("n_devices", nargs="?", type=int, default=1)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--dtype", choices=sorted(_DTYPES),
                        default="float32")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if args.n_devices != 1:
        raise NotImplementedError(
            f"{args.n_devices} devices: the PyTorch package runs on one "
            "device (multi-device is ROADMAP A10)")
    device = torch.device(device if device is not None else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for and is not available "
                           "(use --device cpu to run on the CPU)")
    dtype = dtype if dtype is not None else _DTYPES[args.dtype]
    prm = SimulationParameters.from_file(args.deck, dim=dim)
    solver = GLSNavierStokesSolver(prm, device=device, dtype=dtype)
    solver.solve()
    if not prm.test.enable:
        st = solver.stats
        n = max(st["newton_iterations"], 1)
        print(f"Newton summary: {st['newton_solves']} solves, "
              f"{st['newton_iterations']} iterations, "
              f"{st['linear_iterations']} linear iterations, "
              f"{st['newton_seconds'] / n:.6f} s per Newton iteration, "
              f"{st['host_syncs'] / n:.2f} host syncs per Newton iteration")
    return 0
