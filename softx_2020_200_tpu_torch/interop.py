"""State carried across from the JAX package.

The JAX package's solution and its BDF history (newest first), given as
NumPy arrays (``np.asarray`` of its arrays), become this package's
tensors: the GLS state ``u[N, d+1]``, or the grad-div (GD) solver's flat
mixed state ``x[Nv*d + Np]`` (velocity node-major, then pressure).  Both
packages number nodes and elements the same way (``fem/dof.py`` is a
copy), the GD solver's velocity and pressure nodes included, so a state
moves across unchanged.
"""

from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(u, previous=None, *, device, dtype):
    """-> (u tensor, [previous tensors]) on ``device`` in ``dtype``."""
    def conv(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return conv(u), [conv(p) for p in (previous or [])]
