"""Variable-step BDF time-integration coefficients.

Equivalent of the reference's ``source/core/bdf.cc`` (SURVEY.md §2.1):
``bdf_coefficients(order, dt_vector)`` returns the weights ``alpha[i]`` such
that du/dt at t_n is approximated by ``sum_i alpha[i] * u^{n-i}`` where
``u^{n-0}`` is the *new* solution.  The weights come from differentiating
the Lagrange interpolant through the last ``order+1`` time points — the
standard divided-difference construction, valid for non-uniform steps.

Pure NumPy (host-side, tiny); the resulting scalars feed the jitted step.
"""

from __future__ import annotations

import numpy as np


def bdf_coefficients(order: int, dts) -> np.ndarray:
    """BDF weights for variable time steps.

    Args:
      order: 1, 2 or 3.
      dts: sequence of recent time-step sizes, ``dts[0]`` the current step
        (t_n - t_{n-1}), ``dts[1]`` the previous one, etc. Must have at
        least ``order`` entries.

    Returns:
      ``alpha`` of length ``order+1``: du/dt(t_n) ≈ Σ alpha[i] u^{n-i}.
    """
    if order < 1 or order > 3:
        raise ValueError(f"BDF order must be 1..3, got {order}")
    dts = np.asarray(dts, dtype=np.float64)
    if dts.shape[0] < order:
        raise ValueError(f"need {order} step sizes for BDF{order}")

    # time points t_n=0, t_{n-1}=-dts[0], t_{n-2}=-dts[0]-dts[1], ...
    times = np.zeros(order + 1)
    for i in range(1, order + 1):
        times[i] = times[i - 1] - dts[i - 1]

    # alpha[i] = d/dt of Lagrange basis L_i at t=0
    alpha = np.zeros(order + 1)
    for i in range(order + 1):
        # L_i(t) = prod_{j!=i} (t - t_j)/(t_i - t_j)
        denom = np.prod([times[i] - times[j] for j in range(order + 1) if j != i])
        # derivative at 0: sum over k!=i of prod_{j!=i,k} (0 - t_j) / denom
        s = 0.0
        for k in range(order + 1):
            if k == i:
                continue
            p = 1.0
            for j in range(order + 1):
                if j == i or j == k:
                    continue
                p *= (0.0 - times[j])
            s += p
        alpha[i] = s / denom
    return alpha


def bdf_max_order(n_previous_solutions: int) -> int:
    return min(3, n_previous_solutions)
