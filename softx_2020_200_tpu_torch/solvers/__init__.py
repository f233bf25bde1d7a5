"""The GLS operator, Newton, boundary conditions, analytical solutions,
post-processing and the solver engine (counterpart of
``softx_2020_200_tpu.solvers``)."""
