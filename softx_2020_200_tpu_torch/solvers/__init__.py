"""The GLS and GD operators, Newton, boundary conditions, analytical solutions,
post-processing and the solver engines (counterpart of
``softx_2020_200_tpu.solvers``)."""
