"""Element gather/assembly, the GLS element kernel (plain PyTorch and
CUDA), Krylov solvers and preconditioners (counterpart of
``softx_2020_200_tpu.ops``)."""
