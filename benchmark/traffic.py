"""The general generator of the benchmark's inputs: a cell's file
(``workloads/<name>.json``) over its configuration's deck
(``configs/<config>.json``) and a seed give the deck the solver runs.

A cell's ``deck`` entries override the configuration's (subsection by
subsection).  Its ``perturbation`` adds to each velocity component i a
seeded shear mode of the coordinate after it, A a_i sin(2 pi m_i x_j /
P_j + phi_i) with j = (i + 1) mod d, which is divergence-free: a_i in
[-1, 1], m_i in 1..``max_wavenumber`` and phi_i in [0, 2 pi) from the
seed.  Every seed is then another flow of the same size, steps and
solver settings.
"""

from __future__ import annotations

import copy
import json
import math
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_cell(name: str, bench_dir: str = HERE) -> dict:
    """The cell ``name`` with its configuration under ``config_data``."""
    with open(os.path.join(bench_dir, "workloads", name + ".json")) as fh:
        cell = json.load(fh)
    with open(os.path.join(bench_dir, "configs",
                           cell["config"] + ".json")) as fh:
        cell["config_data"] = json.load(fh)
    return cell


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s values, nested dicts merged."""
    out = copy.deepcopy(base)
    for key, val in over.items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = merge(out[key], val)
        else:
            out[key] = copy.deepcopy(val)
    return out


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of a seed (any whole number) and a stream."""
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def perturbation(spec: dict, dim: int, seed: int) -> list[str]:
    """One expression term per velocity component."""
    r = rng(seed)
    terms = []
    for i in range(dim):
        j = (i + 1) % dim
        a = float(spec["amplitude"]) * r.uniform(-1.0, 1.0)
        k = 2 * math.pi * int(r.integers(1, int(spec["max_wavenumber"]) + 1)) \
            / float(spec["periods"][j])
        phi = r.uniform(0.0, 2 * math.pi)
        terms.append(f"{a!r}*sin({k!r}*{'xyz'[j]} + {phi!r})")
    return terms


def deck_for(cell: dict, seed: int) -> dict:
    """The deck of one run: the configuration's, the cell's overrides,
    the seed's initial field."""
    conf = cell["config_data"]
    dim = int(conf["dim"])
    deck = merge(conf["deck"], cell.get("deck", {}))
    ic = deck["initial conditions"]["uvwp"]
    parts = [p.strip() for p in ic["Function expression"].split(";")]
    for i, term in enumerate(perturbation(cell["perturbation"], dim, seed)):
        parts[i] = f"{parts[i]} + {term}"
    ic["Function expression"] = "; ".join(parts)
    return deck


def render(deck: dict, indent: int = 0) -> str:
    """The deck as ``.prm`` text."""
    pad = "  " * indent
    lines = []
    for key, val in deck.items():
        if isinstance(val, dict):
            lines.append(f"{pad}subsection {key}")
            lines.append(render(val, indent + 1))
            lines.append(f"{pad}end")
        else:
            lines.append(f"{pad}set {key} = {val}")
    return "\n".join(lines)
