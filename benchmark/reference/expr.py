"""Deck function expressions ("sin(x)*cos(y); 0; ...") evaluated with
NumPy in float64, for the plain reference: arithmetic, ``^`` as a power,
the usual functions and ``pi``, in the variables x, y, z and t."""

from __future__ import annotations

import numpy as np

_FUNCS = {name: getattr(np, name) for name in (
    "sin", "cos", "tan", "exp", "log", "sqrt", "tanh", "sinh", "cosh",
    "arctan", "abs")}
_FUNCS.update(atan=np.arctan, pi=np.pi)


def evaluate(text: str, points: np.ndarray, t: float = 0.0) -> np.ndarray:
    """The components of a ';'-separated expression at points [N, d]:
    [N, number of components]."""
    env = dict(_FUNCS, t=t)
    for a, name in enumerate("xyz"[:points.shape[1]]):
        env[name] = points[:, a]
    cols = []
    for part in text.split(";"):
        code = compile(part.strip().replace("^", "**"), "<deck>", "eval")
        for name in code.co_names:
            if name not in env:
                raise ValueError(f"unknown name {name!r} in {part!r}")
        val = eval(code, {"__builtins__": {}}, env)  # noqa: S307
        cols.append(np.broadcast_to(np.asarray(val, float),
                                    (points.shape[0],)))
    return np.stack(cols, axis=1)
