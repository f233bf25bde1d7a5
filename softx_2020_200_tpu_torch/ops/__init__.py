"""Element gather/assembly, the GLS and GD element kernels (plain PyTorch
and CUDA), Krylov solvers, preconditioners and multigrid (counterpart of
``softx_2020_200_tpu.ops``)."""
