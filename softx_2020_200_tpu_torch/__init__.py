"""softx_2020_200_tpu_torch — the GLS and grad-div (GD) Navier-Stokes
solvers in PyTorch.

A port of :mod:`softx_2020_200_tpu` (the JAX reference, which stays in
the repository unchanged) to PyTorch and CUDA for one NVIDIA H100.  The
layout mirrors the reference package module for module:

- ``core``    — .prm decks, typed parameters, expressions, BDF/SDIRK
                coefficients, simulation control (host modules are
                copies of the reference's NumPy-only files).
- ``fem``     — bases, quadrature, meshes, DoFs, geometry, constraints.
- ``ops``     — element gather / gather-sum assembly, strided lattice
                gather/scatter, the element kernels (plain PyTorch and
                the hand-written CUDA kernels in ``csrc/``: GLS on any
                mesh, GLS and GD on lattices), Krylov solvers,
                preconditioners, geometric multigrid.
- ``solvers`` — the GLS and GD operators, Newton, boundary conditions,
                analytical solutions, post-processing, the engines.
- ``utils``   — VTU/PVD writers and text tables.
- ``apps``    — ``gls_navier_stokes_{2,3}d``, ``gd_navier_stokes_{2,3}d``.

The package never imports ``jax``, directly or through the reference.
"""

__version__ = "0.1.0"
