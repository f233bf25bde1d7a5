"""The grad-div Taylor-Hood (GD) lattice kernel on Hopper: constant
tables, plain version, wrapper and dispatch.

On a lattice whose elements are all translates of one box the element
Jacobian is one constant, so the Q(k+1) velocity's values and physical
gradients at the quadrature points are the rows of one constant matrix
``Tv [(d+1)*nq, nnv]``, the Qk pressure's values those of ``Tp [nq,
nnp]``, and the quadrature sums back to the nodes are ``Pv [nnv,
(d+1)*nq]`` and ``Pp [nnp, nq]`` with det*w folded in.  Each element does
interpolate -> pointwise physics -> project:

    alpha0 u + u_prev + (u.grad)u - f      against phi
    nu grad u + (gamma div u - p) I        against grad phi
    div u                                  against psi

``LatticeGDKernel`` replaces the TPU kernel B3
(``softx_2020_200_tpu/ops/pallas_lattice_gd.py``, ``_build_gd_kernel`` at
``:59``, launched at ``:229``); the CUDA source, with its note on what
bounds it on the card, is ``csrc/gd_lattice.cu``.  The mixed state is one
block of component-major rows, as in the JAX package: ``ue[d*nnv + nnp,
E]`` (velocity component i at rows ``i*nnv + n``, then the pressure),
``vpe[d*nnv, E]``, ``fq[d*nq, E]`` (row ``i*nq + q``), out like ``ue``.

The GD weak form has no stabilization parameter, so the tangent is the
exact Jacobian action; it does not depend on ``vpe`` or ``fq``, and the
tangent takes neither.  Dispatch is on the device of the tensors:

- CPU tensors take the plain PyTorch version (``make_lattice_gd_kernel``),
  with the tangent by ``torch.func.jvp``;
- CUDA tensors launch the hand-written kernel (float32);
- anything else raises.  There is no fallback from CUDA to the plain
  version.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch
from torch import nn

from . import cuda_build

SOURCE = os.path.join(cuda_build.CSRC, "gd_lattice.cu")

_PRIMAL, _TANGENT = 0, 1
# (dim, pressure degree, Gauss points per axis): Q2-Q1 with 3 points
SUPPORTED = {(2, 1, 3), (3, 1, 3)}

_BUILD: cuda_build.KernelBuild | None = None


def get_build() -> cuda_build.KernelBuild:
    """The process's compiled GD lattice-kernel library, built at first
    call."""
    global _BUILD
    if _BUILD is None:
        _BUILD = cuda_build.load(
            SOURCE, "gd_lattice_launch",
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6 + [ctypes.c_int64]
            + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    return _BUILD


def gd_affine_tables(dim, Bv, Gv, Bp, w, xe0):
    """Constant tables for one affine element (velocity coords xe0)
    (a copy of the JAX package's ``_gd_affine_tables``).

    Returns (Tv [(d+1)nq, nnv], Pv [nnv, (d+1)nq], Tp [nq, nnp],
    Pp [nnp, nq]): Tv rows are [values; d/dx_0; ...; d/dx_{d-1}]; the
    P matrices are transposes with det*w folded into the columns."""
    d = dim
    J = np.einsum("ni,qnj->qij", xe0, Gv)
    if np.abs(J - J[0]).max() > 1e-9 * max(np.abs(J).max(), 1e-30):
        raise ValueError("element is not affine")
    J0 = J[0]
    detJ = float(np.linalg.det(J0))
    Jinv = np.linalg.inv(J0)
    Gphys = np.einsum("qna,ai->qni", Gv, Jinv)          # [nq, nnv, d]
    Tv = np.concatenate([Bv] + [Gphys[:, :, i] for i in range(d)],
                        axis=0)
    detw = detJ * w                                     # [nq]
    Pv = (Tv * np.tile(detw, d + 1)[:, None]).T
    Tp = Bp
    Pp = (Bp * detw[:, None]).T
    return Tv, Pv, Tp, Pp


def make_lattice_gd_kernel(*, dim: int, nnv: int, nq: int, Tv, Pv, Tp, Pp,
                           nu: float, gamma: float):
    """The plain version: r(ue, vpe, fq, alpha0) on component-major rows,
    the physics of B3's kernel body.  ``vpe`` and ``fq`` may be None (the
    terms they carry are then left out, as the tangent leaves them)."""
    d = dim

    def kernel(ue, vpe, fq, alpha0):
        E = ue.shape[-1]
        prim = torch.einsum("mn,inE->imE", Tv,
                            ue[:d * nnv].reshape(d, nnv, E))  # [i, M, E]
        vel = prim[:, :nq]                                     # [i, q, E]
        gvel = prim[:, nq:].reshape(d, d, nq, E)               # [i, j, q, E]
        pq = Tp @ ue[d * nnv:]                                 # [q, E]
        div = torch.einsum("iiqE->qE", gvel)
        a_v = alpha0 * vel + torch.einsum("ijqE,jqE->iqE", gvel, vel)
        if vpe is not None:
            a_v = a_v + torch.einsum("qn,inE->iqE", Tv[:nq],
                                     vpe.reshape(d, nnv, E))
        if fq is not None:
            a_v = a_v - fq.reshape(d, nq, E)
        eye = torch.eye(d, dtype=ue.dtype, device=ue.device)[:, :, None,
                                                               None]
        a_g = nu * gvel + (gamma * div - pq) * eye
        stack = torch.cat([a_v[:, None], a_g], dim=1)          # [i, d+1, q, E]
        out_v = torch.einsum("nm,imE->inE", Pv,
                             stack.reshape(d, (d + 1) * nq, E))
        return torch.cat([out_v.reshape(d * nnv, E), Pp @ div])

    return kernel


class LatticeGDKernel(nn.Module):
    """Residual and exact tangent of the GD weak form on a lattice of
    translates of the velocity element ``xe0`` [nnv, d].

    ``launches`` counts CUDA kernel launches (class-wide), and
    ``launches_by_shape`` the same per (dim, velocity degree, points per
    axis, E, variant); the plain version on CPU tensors does not count.
    """

    launches = 0
    launches_by_shape: dict = {}

    def __init__(self, *, dim: int, degree_pressure: int, Bv, Gv, Bp, w,
                 xe0, nu: float, gamma: float,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.dim, self.degree_pressure = dim, degree_pressure
        self.nq, self.nnv = np.asarray(Bv).shape
        self.nnp = np.asarray(Bp).shape[1]
        self.rows = dim * self.nnv + self.nnp
        self.nu, self.gamma = float(nu), float(gamma)
        tables = gd_affine_tables(dim, Bv, Gv, Bp, w, xe0)
        for name, t in zip(("Tv", "Pv", "Tp", "Pp"), tables):
            self.register_buffer(name, torch.as_tensor(
                np.array(t), dtype=dtype, device=device))
        # packed float32 tables for the CUDA kernel: Tv, Pv, Tp, Pp, each
        # row-major
        self.register_buffer("tables", torch.as_tensor(
            np.concatenate([t.reshape(-1) for t in tables]),
            dtype=torch.float32, device=device))

    def plain(self):
        """The plain PyTorch kernel on this module's tables."""
        return make_lattice_gd_kernel(
            dim=self.dim, nnv=self.nnv, nq=self.nq, Tv=self.Tv, Pv=self.Pv,
            Tp=self.Tp, Pp=self.Pp, nu=self.nu, gamma=self.gamma)

    def _on_cuda(self, ue) -> bool:
        if ue.device.type == "cpu":
            return False
        if ue.device.type != "cuda":
            raise ValueError(f"no GD lattice kernel for device {ue.device}")
        return True

    # ------------------------------------------------------------------
    def residual(self, ue, vpe, fq, alpha0):
        """r[d*nnv + nnp, E]: the element residuals."""
        if not self._on_cuda(ue):
            return self.plain()(ue, vpe, fq, alpha0)
        out = torch.empty_like(ue)
        self._launch(_PRIMAL, ue, None, vpe, fq, out, alpha0)
        return out

    def tangent(self, ue, due, alpha0):
        """dr[d*nnv + nnp, E] along ``due``: the exact Jacobian action."""
        if not self._on_cuda(ue):
            return torch.func.jvp(
                lambda v: self.plain()(v, None, None, alpha0), (ue,),
                (due,))[1]
        out = torch.empty_like(ue)
        self._launch(_TANGENT, ue, due, None, None, out, alpha0)
        return out

    # ------------------------------------------------------------------
    def _launch(self, mode, ue, due, vpe, fq, out, alpha0):
        d, nq = self.dim, self.nq
        q1d = round(nq ** (1 / d))
        if (d, self.degree_pressure, q1d) not in SUPPORTED or q1d ** d != nq:
            raise ValueError(
                f"CUDA GD lattice kernel: no variant for dim={d}, pressure "
                f"degree={self.degree_pressure} with {nq} quadrature points "
                "(compiled: Q2-Q1 in 2D/3D with 3 points per axis)")
        E = ue.shape[-1]
        expect = [(ue, (self.rows, E)), (out, (self.rows, E)),
                  (self.tables, self.tables.shape)]
        if mode == _TANGENT:
            expect.append((due, (self.rows, E)))
        else:
            expect += [(vpe, (d * self.nnv, E)), (fq, (d * nq, E))]
        for t, shape in expect:
            if (t.device != ue.device or t.dtype != torch.float32
                    or not t.is_contiguous() or tuple(t.shape) != shape):
                raise ValueError(
                    "CUDA GD lattice kernel takes contiguous float32 "
                    f"tensors on {ue.device}: got {tuple(t.shape)} "
                    f"{t.dtype} on {t.device} where {shape} was expected")
        lib = get_build().lib
        stream = torch.cuda.current_stream(ue.device).cuda_stream
        err = lib.gd_lattice_launch(
            d, self.degree_pressure, mode, ue.data_ptr(),
            due.data_ptr() if due is not None else None,
            vpe.data_ptr() if vpe is not None else None,
            fq.data_ptr() if fq is not None else None,
            self.tables.data_ptr(), out.data_ptr(), E, self.nu, self.gamma,
            float(alpha0), stream)
        if err != 0:
            raise RuntimeError(f"GD lattice kernel launch failed: CUDA "
                               f"error {err}")
        cls = LatticeGDKernel
        cls.launches += 1
        key = (d, self.degree_pressure + 1, q1d, E,
               ("primal", "tangent")[mode])
        cls.launches_by_shape[key] = cls.launches_by_shape.get(key, 0) + 1
