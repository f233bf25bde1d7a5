"""softx_2020_200_tpu_torch — the GLS Navier-Stokes main path in PyTorch.

A port of :mod:`softx_2020_200_tpu` (the JAX reference, which stays in
the repository unchanged) to PyTorch and CUDA for one NVIDIA H100.  The
layout mirrors the reference package module for module:

- ``core``    — .prm decks, typed parameters, expressions, BDF/SDIRK
                coefficients, simulation control (host modules are
                copies of the reference's NumPy-only files).
- ``fem``     — bases, quadrature, meshes, DoFs, geometry, constraints.
- ``ops``     — element gather / gather-sum assembly, the GLS element
                kernel (plain PyTorch and the hand-written CUDA kernel
                in ``csrc/gls_element.cu``), Krylov solvers,
                preconditioners.
- ``solvers`` — the GLS operator, Newton, boundary conditions,
                analytical solutions, post-processing, the engine.
- ``utils``   — VTU/PVD writers and text tables.
- ``apps``    — ``gls_navier_stokes_2d`` / ``gls_navier_stokes_3d``.

The package never imports ``jax``, directly or through the reference.
"""

__version__ = "0.1.0"
