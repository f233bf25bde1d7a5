"""FEM core: bases, quadrature, meshes, DoFs, geometry and constraints
(counterpart of ``softx_2020_200_tpu.fem``)."""
