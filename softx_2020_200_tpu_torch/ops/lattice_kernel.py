"""The GLS lattice kernel on Hopper: constant tables, plain version,
wrapper and dispatch.

On a lattice whose elements are all translates of one box the element
Jacobian is one constant, so values, physical gradients and Laplacians
at the quadrature points are the rows of one constant matrix
``T_all [(d+2)*nq, nn]``, and the quadrature sum back to the nodes is
``T_proj [nn, (d+2)*nq]`` with det*w folded in.  Each element does
interpolate -> pointwise physics -> project, with no geometry stream.

``LatticeGLSKernel`` replaces the TPU kernel B2
(``softx_2020_200_tpu/ops/pallas_lattice.py``, ``_build_kernel`` at
``:103``, launched at ``:391``); the CUDA source, with its note on what
bounds it on the card, is ``csrc/gls_lattice.cu``.  Rows are
component-major, as in the JAX package: ``ue[c*nn, E]`` (row k*nn + n),
``up[d*nn, E]``, ``fq[d*nq, E]`` (row i*nq + q), out ``[c*nn, E]``.

Dispatch is on the device of the tensors it is given:

- CPU tensors take the plain PyTorch version (``make_lattice_kernel``):
  ``T_all @ rows``, pointwise physics, ``T_proj @ stack``, with tangents
  by ``torch.func.jvp`` (exact tau, or tau and the LSIC coefficient
  frozen when the stabilization flags say so);
- CUDA tensors launch the hand-written kernel (float32; its tangent is
  the frozen-tau linearization, as B2's);
- anything else raises.  There is no fallback from CUDA to the plain
  version.
"""

from __future__ import annotations

import ctypes
import math
import os

import numpy as np
import torch
from torch import nn

from . import cuda_build

SOURCE = os.path.join(cuda_build.CSRC, "gls_lattice.cu")

_PRIMAL, _TANGENT, _PROBE = 0, 1, 2
# (dim, degree, Gauss points per axis): Q1/Q2 with degree + 1 points, and
# Q1 with 3, which the Q1 multigrid levels of a Q2 deck use
SUPPORTED = {(2, 1, 2), (2, 2, 3), (3, 1, 2), (3, 2, 3), (2, 1, 3),
             (3, 1, 3)}

_BUILD: cuda_build.KernelBuild | None = None


def get_build() -> cuda_build.KernelBuild:
    """The process's compiled lattice-kernel library, built at first
    call."""
    global _BUILD
    if _BUILD is None:
        _BUILD = cuda_build.load(
            SOURCE, "gls_lattice_launch",
            [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6
            + [ctypes.c_int64] + [ctypes.c_float] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_void_p])
    return _BUILD


def affine_tables(dim, nn, nq, B, G, H, w, xe0, degree):
    """Constant interpolation/projection operators for one affine
    element whose node coordinates are ``xe0`` [nn, d] (a copy of the
    JAX package's ``_affine_tables``).

    Returns (T_all [(d+2)*nq, nn], T_proj [nn, (d+2)*nq], h, detJ):
      rows [0:nq]              values            (B)
      rows [(1+i)*nq:(2+i)*nq] d/dx_i            (G @ Jinv)
      rows [(1+d)*nq:(2+d)*nq] laplacian         (H : Jinv Jinv^T)
    T_proj is T_all transposed with det*w folded into its columns, so
    ``out = T_proj @ coeffs`` IS the quadrature sum.
    """
    d = dim
    J = np.einsum("ni,qnj->qij", xe0, G)             # [nq, d, d]
    if np.abs(J - J[0]).max() > 1e-9 * max(np.abs(J).max(), 1e-30):
        raise ValueError("element is not affine")
    J0 = J[0]
    detJ = float(np.linalg.det(J0))
    Jinv = np.linalg.inv(J0)                          # dxi/dx
    K = Jinv @ Jinv.T                                 # [a, b]

    Gphys = np.einsum("qna,ai->qni", G, Jinv)         # [nq, nn, d]
    lap_phi = np.einsum("qnab,ab->qn", H, K)          # [nq, nn]

    T = np.concatenate(
        [B] + [Gphys[:, :, i] for i in range(d)] + [lap_phi], axis=0)
    detw = detJ * w                                   # [nq]
    scale_col = np.tile(detw, d + 2)                  # per T row
    T_proj = (T * scale_col[:, None]).T               # [nn, (d+2)nq]

    vol = detJ * float(np.sum(w))
    if d == 2:
        h = math.sqrt(4.0 * vol / math.pi) / degree
    else:
        h = (6.0 * vol / math.pi) ** (1.0 / 3.0) / degree
    return T, T_proj, h, detJ


def is_translate_lattice(xe: np.ndarray, G) -> bool:
    """Whether element 0 of ``xe`` [E, nn, d] is affine (its Jacobian is
    the same at every quadrature point of ``G`` [nq, nn, d], as
    ``affine_tables`` requires) and every element is a translate of it
    (sampled at scale as in the JAX package: node offsets from node 0 of
    up to 4096 elements spread over the mesh)."""
    J = np.einsum("ni,qnj->qij", xe[0], G)
    if np.abs(J - J[0]).max() > 1e-9 * max(np.abs(J).max(), 1e-30):
        return False
    E = xe.shape[0]
    sample = np.unique(np.linspace(0, E - 1, 4096).astype(np.int64))
    rel = xe[sample] - xe[sample, :1]
    return bool(np.abs(rel - rel[0]).max()
                <= 1e-9 * max(np.abs(rel[0]).max(), 1e-30))


def make_lattice_kernel(*, dim: int, nn: int, nq: int, T_all, T_proj,
                        h: float, nu: float, stab):
    """The plain version: r(ue, up, fq, alpha0, sdt) on component-major
    rows, the physics of B2's kernel body.  With ``stab.frozen_tau``
    tau and the LSIC coefficient are detached (B2's tangent)."""
    d = dim
    M, Mnl = (d + 2) * nq, (d + 1) * nq
    inv_h2 = 1.0 / (h * h)
    visc_term = 9.0 * (4.0 * nu) ** 2 * inv_h2 * inv_h2

    def kernel(ue, up, fq, alpha0, sdt):
        E = ue.shape[-1]
        prim = torch.einsum("mn,knE->kmE", T_all,
                            ue.reshape(d + 1, nn, E))        # [c, M, E]
        vel = prim[:d, :nq]                                  # [i, q, E]
        gvel = prim[:d, nq:Mnl].reshape(d, d, nq, E)         # [i, j, q, E]
        lap = prim[:d, Mnl:]
        p = prim[d, :nq]
        gp = prim[d, nq:Mnl].reshape(d, nq, E)
        upv = torch.einsum("qn,inE->iqE", T_all[:nq], up.reshape(d, nn, E))
        f = fq.reshape(d, nq, E)

        udot = alpha0 * vel + upv
        conv = torch.einsum("ijqE,jqE->iqE", gvel, vel)
        r_m = udot + conv + gp - nu * lap - f
        div = torch.einsum("iiqE->qE", gvel)
        umag2 = torch.sum(vel * vel, dim=0)
        tau = torch.rsqrt(sdt * sdt + 4.0 * umag2 * inv_h2 + visc_term)
        tau_l = 0.5 * torch.sqrt(umag2) * h
        if stab.frozen_tau:
            tau, tau_l = tau.detach(), tau_l.detach()

        eye = torch.eye(d, dtype=ue.dtype, device=ue.device)[:, :, None,
                                                               None]
        a_v = udot + conv - f
        a_g = nu * gvel - p * eye
        if stab.supg:
            a_g = a_g + tau * r_m[:, None] * vel[None]
        if stab.lsic:
            a_g = a_g + tau_l * div * eye
        zero = torch.zeros_like(r_m)
        a_lap = -tau * nu * r_m if stab.gls_viscous_adjoint else zero
        a_pg = tau * r_m if stab.pspg else zero
        stack_v = torch.cat([a_v[:, None], a_g, a_lap[:, None]], dim=1)
        out_v = torch.einsum("nm,imE->inE", T_proj,
                             stack_v.reshape(d, M, E))
        out_p = T_proj[:, :Mnl] @ torch.cat([div[None], a_pg]).reshape(
            Mnl, E)
        return torch.cat([out_v, out_p[None]]).reshape((d + 1) * nn, E)

    return kernel


def lattice_tangent(kernel, ue, due, up, fq, alpha0, sdt):
    """d r / d ue along ``due``, by forward-mode AD."""
    return torch.func.jvp(lambda v: kernel(v, up, fq, alpha0, sdt),
                          (ue,), (due,))[1]


def lattice_node_blocks(kernel, ue, up, fq, alpha0, sdt, nn: int):
    """Node-diagonal Jacobian blocks [nn, c*c, E] (row-major (i, j)) from
    nn*c forward-mode probes."""
    cn, E = ue.shape
    c = cn // nn
    out = ue.new_empty((nn, c * c, E))
    for n0 in range(nn):
        for j in range(c):
            probe = torch.zeros_like(ue)
            probe[j * nn + n0] = 1.0
            col = lattice_tangent(kernel, ue, probe, up, fq, alpha0, sdt)
            out[n0, j::c] = col[n0::nn]
    return out


class LatticeGLSKernel(nn.Module):
    """Residual, tangent and node-block probes of the GLS weak form on a
    lattice of translates of the element ``xe0`` [nn, d].

    ``launches`` counts CUDA kernel launches (class-wide); the plain
    version on CPU tensors does not count.
    """

    launches = 0

    def __init__(self, *, dim: int, degree: int, B, G, H, w, xe0,
                 nu: float, stab, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.dim, self.degree = dim, degree
        self.nc = dim + 1
        self.nq, self.nn = B.shape
        self.nu = float(nu)
        self.stab = stab
        T, P, h, _ = affine_tables(
            dim, self.nn, self.nq, B, G,
            np.asarray(H).reshape(self.nq, self.nn, dim, dim), w, xe0,
            degree)
        self.h = h
        self.register_buffer("T_all", torch.as_tensor(T, dtype=dtype,
                                                      device=device))
        self.register_buffer("T_proj", torch.as_tensor(P, dtype=dtype,
                                                       device=device))
        # packed float32 tables for the CUDA kernel: T_all then T_proj,
        # each row-major
        self.register_buffer("tables", torch.as_tensor(
            np.concatenate([T.reshape(-1), P.reshape(-1)]),
            dtype=torch.float32, device=device))
        self._plain_cache = {}

    def plain(self, stab=None):
        """The plain PyTorch kernel on this module's device and dtype
        (``stab`` overrides the stabilization flags, e.g. frozen tau)."""
        stab = stab or self.stab
        key = (stab, self.T_all.dtype, self.T_all.device)
        if key not in self._plain_cache:
            self._plain_cache[key] = make_lattice_kernel(
                dim=self.dim, nn=self.nn, nq=self.nq, T_all=self.T_all,
                T_proj=self.T_proj, h=self.h, nu=self.nu, stab=stab)
        return self._plain_cache[key]

    def _on_cuda(self, ue) -> bool:
        if ue.device.type == "cpu":
            return False
        if ue.device.type != "cuda":
            raise ValueError(f"no GLS lattice kernel for device {ue.device}")
        return True

    # ------------------------------------------------------------------
    def residual(self, ue, up, fq, alpha0, sdt):
        """r[c*nn, E]: the element residuals (full tau)."""
        if not self._on_cuda(ue):
            return self.plain()(ue, up, fq, alpha0, sdt)
        out = torch.empty_like(ue)
        self._launch(_PRIMAL, ue, None, up, fq, out, alpha0, sdt)
        return out

    def tangent(self, ue, due, up, fq, alpha0, sdt):
        """dr[c*nn, E] along ``due``: exact or frozen tau per the flags on
        CPU; frozen tau on CUDA."""
        if not self._on_cuda(ue):
            return lattice_tangent(self.plain(), ue, due, up, fq, alpha0,
                                   sdt)
        out = torch.empty_like(ue)
        self._launch(_TANGENT, ue, due, up, fq, out, alpha0, sdt)
        return out

    def node_blocks(self, ue, up, fq, alpha0, sdt):
        """Element node-diagonal Jacobian blocks [nn, c*c, E] (row-major
        (i, j)): on CUDA one probe launch per (node, component)."""
        if not self._on_cuda(ue):
            return lattice_node_blocks(self.plain(), ue, up, fq, alpha0,
                                       sdt, self.nn)
        c, E = self.nc, ue.shape[-1]
        out = ue.new_empty((self.nn, c * c, E))
        for n0 in range(self.nn):
            for j in range(c):
                self._launch(_PROBE, ue, None, up, fq, out, alpha0, sdt,
                             probe=(n0, j))
        return out

    # ------------------------------------------------------------------
    def _launch(self, mode, ue, due, up, fq, out, alpha0, sdt,
                probe=(0, 0)):
        d, nn, nq, c = self.dim, self.nn, self.nq, self.nc
        q1d = round(nq ** (1 / d))
        if (d, self.degree, q1d) not in SUPPORTED or q1d ** d != nq:
            raise ValueError(
                f"CUDA GLS lattice kernel: no variant for dim={d}, degree="
                f"{self.degree} with {nq} quadrature points (compiled: "
                f"Q1/Q2 in 2D/3D with degree+1 points per axis, and Q1 "
                f"with 3)")
        E = ue.shape[-1]
        expect = [(ue, (c * nn, E)), (up, (d * nn, E)), (fq, (d * nq, E)),
                  (out, out.shape), (self.tables, self.tables.shape)]
        if due is not None:
            expect.append((due, (c * nn, E)))
        for t, shape in expect:
            if (t.device != ue.device or t.dtype != torch.float32
                    or not t.is_contiguous() or tuple(t.shape) != shape):
                raise ValueError(
                    "CUDA GLS lattice kernel takes contiguous float32 "
                    f"tensors on {ue.device}: got {tuple(t.shape)} "
                    f"{t.dtype} on {t.device} where {shape} was expected")
        lib = get_build().lib
        stream = torch.cuda.current_stream(ue.device).cuda_stream
        err = lib.gls_lattice_launch(
            d, self.degree, q1d, mode, ue.data_ptr(),
            due.data_ptr() if due is not None else None, up.data_ptr(),
            fq.data_ptr(), self.tables.data_ptr(), out.data_ptr(), E,
            self.nu, self.h, float(alpha0), float(sdt),
            int(self.stab.supg), int(self.stab.pspg),
            int(self.stab.gls_viscous_adjoint), int(self.stab.lsic),
            probe[0], probe[1], stream)
        if err != 0:
            raise RuntimeError(f"GLS lattice kernel launch failed: CUDA "
                               f"error {err}")
        LatticeGLSKernel.launches += 1
