"""The GLS element kernel on Hopper: wrapper, build and dispatch.

``GLSElementKernel`` evaluates the stabilized GLS weak form of every
element in the SoA row layout of ``ops/batched_kernel.py``.  It replaces
the TPU kernel B1 (``softx_2020_200_tpu/ops/pallas_gls.py``,
``_build_kernel``, launched at ``:413``); the CUDA source, with its note
on what bounds it on the card, is ``csrc/gls_element.cu``.

Dispatch is on the device of the tensors it is given:

- CPU tensors take the plain PyTorch version (``make_batched_kernel``),
  with tangents by ``torch.func.jvp`` (exact tau, or frozen tau when the
  stabilization flags say so, like the JAX package's XLA path);
- CUDA tensors launch the hand-written kernel, whose tangent is the
  frozen-tau linearization (as B1's); float32 only;
- anything else raises.  There is no fallback from CUDA to the plain
  version.

The kernel is compiled by ``nvcc`` from ``csrc/gls_element.cu`` at first
use into ``build/`` next to this package, and loaded with ``ctypes``
(``ops/cuda_build.py``).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch
from torch import nn

from . import cuda_build
from .batched_kernel import (make_batched_kernel, node_blocks_batched,
                             tangent_batched)

SOURCE = os.path.join(cuda_build.CSRC, "gls_element.cu")

_PRIMAL, _TANGENT, _PROBE = 0, 1, 2
SUPPORTED = {(2, 1), (2, 2), (3, 1), (3, 2)}

_BUILD: cuda_build.KernelBuild | None = None


def get_build() -> cuda_build.KernelBuild:
    """The process's compiled kernel library, built at first call."""
    global _BUILD
    if _BUILD is None:
        _BUILD = cuda_build.load(
            SOURCE, "gls_element_launch",
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
            + [ctypes.c_int64] + [ctypes.c_float] * 3 + [ctypes.c_int] * 6
            + [ctypes.c_void_p])
    return _BUILD


class GLSElementKernel(nn.Module):
    """Residual, tangent and node-block probes of the GLS element
    kernel, on the SoA rows ``ue[nn, c, E]``, ``xe[nn, d, E]``,
    ``up[nn, d, E]``, ``fq[q, d, E]``, ``h[E]``.

    ``launches`` counts CUDA kernel launches (class-wide); the plain
    version on CPU tensors does not count.
    """

    launches = 0

    def __init__(self, *, dim: int, degree: int, B, G, H, w, nu: float,
                 stab, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.dim, self.degree = dim, degree
        self.nc = dim + 1
        self.nn, self.nq = B.shape[1], B.shape[0]
        self.nu = float(nu)
        self.stab = stab
        for name, arr in (("B", B), ("G", G), ("H", H), ("w", w)):
            self.register_buffer(name, torch.as_tensor(
                np.array(arr), dtype=dtype, device=device))
        # packed float32 tables for the CUDA kernel: B[q, n], G[q, n, a],
        # H[q, n, a, b], w[q], each flattened q-major
        packed = np.concatenate([np.asarray(a, np.float64).reshape(-1)
                                 for a in (B, G, H, w)])
        self.register_buffer("tables", torch.as_tensor(
            packed, dtype=torch.float32, device=device))
        self._plain_cache = {}

    # ------------------------------------------------------------------
    def plain(self, stab=None):
        """The plain PyTorch kernel on this module's device and dtype
        (``stab`` overrides the stabilization flags, e.g. frozen tau)."""
        stab = stab or self.stab
        key = (stab, self.B.dtype, self.B.device)
        if key not in self._plain_cache:
            self._plain_cache[key] = make_batched_kernel(
                dim=self.dim, B=self.B, G=self.G, H=self.H, w=self.w,
                nu=self.nu, stab=stab)
        return self._plain_cache[key]

    def _on_cuda(self, ue) -> bool:
        if ue.device.type == "cpu":
            return False
        if ue.device.type != "cuda":
            raise ValueError(f"no GLS element kernel for device {ue.device}")
        return True

    # ------------------------------------------------------------------
    def residual(self, ue, xe, up, fq, h, alpha0, sdt):
        """r[nn, c, E]: the element residuals (full tau)."""
        if not self._on_cuda(ue):
            return self.plain()(ue, xe, up, fq, h, alpha0, sdt)
        out = torch.empty_like(ue)
        self._launch(_PRIMAL, ue, None, xe, up, fq, h, out, alpha0, sdt)
        return out

    def tangent(self, ue, due, xe, up, fq, h, alpha0, sdt):
        """dr[nn, c, E] along ``due``: exact or frozen tau per the flags
        on CPU; frozen tau on CUDA."""
        if not self._on_cuda(ue):
            return tangent_batched(self.plain(), ue, due, xe, up, fq, h,
                                   alpha0, sdt)
        out = torch.empty_like(ue)
        self._launch(_TANGENT, ue, due, xe, up, fq, h, out, alpha0, sdt)
        return out

    def node_blocks(self, ue, xe, up, fq, h, alpha0, sdt):
        """Element node-diagonal Jacobian blocks [nn, c*c, E] (row-major
        (i, j)): on CUDA one probe launch per (node, component)."""
        if not self._on_cuda(ue):
            return node_blocks_batched(self.plain(), ue, xe, up, fq, h,
                                       alpha0, sdt)
        nn, c, E = ue.shape
        out = ue.new_empty((nn, c * c, E))
        for n0 in range(nn):
            for j in range(c):
                self._launch(_PROBE, ue, None, xe, up, fq, h, out, alpha0,
                             sdt, probe=(n0, j))
        return out

    # ------------------------------------------------------------------
    def _launch(self, mode, ue, due, xe, up, fq, h, out, alpha0, sdt,
                probe=(0, 0)):
        d, nn, nq, c = self.dim, self.nn, self.nq, self.nc
        if (d, self.degree) not in SUPPORTED or nq != nn:
            raise ValueError(
                f"CUDA GLS kernel: no variant for dim={d}, degree="
                f"{self.degree} with {nq} quadrature points (compiled: "
                f"Q1/Q2 in 2D/3D with degree+1 points per axis)")
        E = ue.shape[-1]
        expect = [(ue, (nn, c, E)), (xe, (nn, d, E)), (up, (nn, d, E)),
                  (fq, (nq, d, E)), (h, (E,)), (out, out.shape),
                  (self.tables, self.tables.shape)]
        if due is not None:
            expect.append((due, (nn, c, E)))
        for t, shape in expect:
            if (t.device != ue.device or t.dtype != torch.float32
                    or not t.is_contiguous() or tuple(t.shape) != shape):
                raise ValueError(
                    "CUDA GLS kernel takes contiguous float32 tensors on "
                    f"{ue.device}: got {tuple(t.shape)} {t.dtype} on "
                    f"{t.device} where {shape} was expected")
        lib = get_build().lib
        supg, pspg, adj, lsic = (int(self.stab.supg), int(self.stab.pspg),
                                 int(self.stab.gls_viscous_adjoint),
                                 int(self.stab.lsic))
        stream = torch.cuda.current_stream(ue.device).cuda_stream
        err = lib.gls_element_launch(
            d, self.degree, mode, ue.data_ptr(),
            due.data_ptr() if due is not None else None, xe.data_ptr(),
            up.data_ptr(), fq.data_ptr(), h.data_ptr(),
            self.tables.data_ptr(), out.data_ptr(), E, self.nu,
            float(alpha0), float(sdt), supg, pspg, adj, lsic,
            probe[0], probe[1], stream)
        if err != 0:
            raise RuntimeError(f"GLS element kernel launch failed: CUDA "
                               f"error {err}")
        GLSElementKernel.launches += 1
