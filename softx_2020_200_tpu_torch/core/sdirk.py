"""SDIRK Butcher tableaux for implicit multi-stage time stepping.

Equivalent of the reference's ``source/core/sdirk.cc`` (SURVEY.md §2.1):
``sdirk_coefficients(order, dt)`` returns the coefficient table used to
sequence the per-stage implicit solves.

The reference uses the classical 2-stage order-2 (Alexander) and 3-stage
order-3 SDIRK schemes, both L-stable with constant diagonal gamma.
"""

from __future__ import annotations

import math

import numpy as np


def sdirk_coefficients(order: int, dt: float) -> np.ndarray:
    """Return the SDIRK table scaled by 1/dt, matching BDF-style use.

    For each stage s the implicit solve is
        du/dt ≈ table[s,0]*u_stage - sum_{j>=1} table[s,j]*u_prev_stage_j
    i.e. column 0 multiplies the unknown stage value and the remaining
    columns multiply earlier stage values / the step start value.
    """
    if order == 2:
        # Alexander's 2-stage, gamma = 1 - 1/sqrt(2)
        g = 1.0 - 1.0 / math.sqrt(2.0)
        A = np.array([[g, 0.0], [1.0 - g, g]])
        c = np.array([g, 1.0])
    elif order == 3:
        # 3-stage, order-3 SDIRK; gamma is the root of
        # g^3 - 3g^2 + 3g/2 - 1/6 = 0 near 0.4358665215
        g = 0.435866521508459
        b1 = -(6.0 * g * g - 16.0 * g + 1.0) / 4.0
        b2 = (6.0 * g * g - 20.0 * g + 5.0) / 4.0
        A = np.array([
            [g, 0.0, 0.0],
            [(1.0 - g) / 2.0, g, 0.0],
            [b1, b2, g],
        ])
        c = A.sum(axis=1)
    else:
        raise ValueError(f"SDIRK order must be 2 or 3, got {order}")

    n = A.shape[0]
    table = np.zeros((n, n + 2))
    # invert the lower-triangular stage coupling into BDF-like weights:
    # stage s solves (u_s - u_n)/dt = sum_j A[s,j] f(u_j); expressing
    # f(u_s) = (u_s - u_n - dt*sum_{j<s} A[s,j] f(u_j)) / (dt*A[s,s]).
    # We return the A matrix, c nodes and dt for the stage driver to use.
    table[:, :n] = A
    table[:, n] = c
    table[:, n + 1] = dt
    return table
