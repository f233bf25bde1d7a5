#!/usr/bin/env python3
"""Two series files of the validation drivers side by side: the rows
whose first column (t, or y for a centerline) agrees to 1e-9, and per
further column the largest absolute difference, where it is, and the
largest value of the reference column.

    python3 scripts/compare_series.py docs/torch_tgv96_series.dat \\
        docs/tgv96_series.dat
    python3 scripts/compare_series.py docs/torch_cylinder_q2r4m6_forces.dat \\
        docs/cylinder_forces.dat --scale 20

``--scale`` multiplies the differences and values (20 turns a force
into a coefficient, 2 F / (U^2 D) with U = 1, D = 0.1).  NumPy only.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def common_rows(a: np.ndarray, b: np.ndarray):
    """The rows of ``a`` and ``b`` whose first columns agree to 1e-9."""
    keys = np.round(b[:, 0], 9)
    index = {k: i for i, k in enumerate(keys)}
    ia, ib = [], []
    for i, k in enumerate(np.round(a[:, 0], 9)):
        j = index.get(k)
        if j is not None:
            ia.append(i)
            ib.append(j)
    return a[ia], b[ib]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("series")
    parser.add_argument("reference")
    parser.add_argument("--scale", type=float, default=1.0)
    args = parser.parse_args(argv)
    a = np.loadtxt(args.series, ndmin=2)
    b = np.loadtxt(args.reference, ndmin=2)
    with open(args.series) as fh:
        head = fh.readline().lstrip("# ").split()
    a, b = common_rows(a, b)
    print(f"{len(a)} common rows ({args.series}: {head})")
    for c in range(1, min(a.shape[1], b.shape[1])):
        d = np.abs(a[:, c] - b[:, c]) * args.scale
        i = int(np.nanargmax(d))
        name = head[c] if c < len(head) else f"column {c}"
        print(f"{name}: largest difference {d[i]:.6e} at {a[i, 0]:.6g} "
              f"({a[i, c] * args.scale:.9e} against "
              f"{b[i, c] * args.scale:.9e}); largest |reference| "
              f"{np.nanmax(np.abs(b[:, c])) * args.scale:.6e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
