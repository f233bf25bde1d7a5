"""The grad-div Taylor-Hood (GD) lattice kernel on Hopper: constant
tables, plain version, wrapper and dispatch.

On a lattice whose elements are all translates of one element the
element Jacobian is one constant, so the Q(k+1) velocity's values and
physical gradients at the quadrature points are the rows of one constant
matrix ``Tv [(d+1)*nq, nnv]``, the Qk pressure's values those of ``Tp
[nq, nnp]``, and the quadrature sums back to the nodes are ``Pv [nnv,
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

The CUDA kernel computes the same function by sum factorization: the
bases and the Gauss points are tensor products, so it takes the 1D tables
(``gd_1d_tables``: the Q2 and Q1 values and the Q2 derivatives at the 3
Gauss points, the same with the weights and det J folded in) and J^-1,
passed in its parameters; the dense tables stay for the plain version.

The GD weak form has no stabilization parameter, so the tangent is the
exact Jacobian action; it does not depend on ``vpe`` or ``fq``, and the
tangent takes neither.  Dispatch is on the device of the tensors:

- CPU tensors take the plain PyTorch version (``make_lattice_gd_kernel``),
  with the tangent by ``torch.func.jvp``;
- CUDA tensors launch the hand-written kernel (float32), on a persistent
  grid (``ops/persistent_tiles.py``) and one of two routes chosen per
  launch from E (``route_for``): STAGED (2D and 3D: element tiles through
  a shared-memory ring, one thread per pencil and element) or REGISTERS
  (2D: one thread per element);
- anything else raises.  There is no fallback from CUDA to the plain
  version.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch
from torch import nn

from ..fem.basis import LagrangeBasis1D
from ..fem.quadrature import gauss_legendre_1d
from . import cuda_build
from . import persistent_tiles as pt

SOURCE = os.path.join(cuda_build.CSRC, "gd_lattice.cu")

_PRIMAL, _TANGENT = 0, 1
MODES = ("primal", "tangent")
ROUTE_NAMES = ("staged", "registers")
# (dim, pressure degree, Gauss points per axis): Q2-Q1 with 3 points
SUPPORTED = {(2, 1, 3), (3, 1, 3)}
# the dims with a REGISTERS route (one thread per element holds 2 x 22
# rows in 2D; 2 x 89 in 3D would not fit)
REGISTER_DIMS = {2}
REG_THREADS = 128
# a launch takes REGISTERS from this many elements per SM on, STAGED
# below: REGISTERS was the faster route at 124 and 496 elements per SM
# (2D 128^2 and 256^2 on an H100; PERF.md)
REG_MIN_PER_SM = 96
STAGED_BE = 32             # elements of a STAGED tile: one warp
TABLE_FLOATS = 81

_BUILD: cuda_build.KernelBuild | None = None
_CONFIG: dict = {}


def get_build() -> cuda_build.KernelBuild:
    """The process's compiled GD lattice-kernel library, built at first
    call."""
    global _BUILD
    if _BUILD is None:
        _BUILD = cuda_build.load(
            SOURCE, "gd_lattice_launch",
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6 + [ctypes.c_int64]
            + [ctypes.c_float] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        _BUILD.lib.gd_lattice_config.restype = ctypes.c_int
        _BUILD.lib.gd_lattice_config.argtypes = (
            [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3)
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


def affine_geometry(xe0, Gv):
    """(J^-1 [d, d], det J) of the affine element ``xe0`` [nnv, d], from
    its Jacobian at the first quadrature point (``gd_affine_tables``
    checks it is the same at every point)."""
    J0 = np.einsum("ni,nj->ij", np.asarray(xe0, np.float64),
                   np.asarray(Gv, np.float64)[0])
    return np.linalg.inv(J0), float(np.linalg.det(J0))


def gd_1d_tables(dim: int, Jinv, detJ: float) -> dict:
    """The CUDA kernel's tables, from the port's 1D Q2 and Q1 Lagrange
    bases (``fem/basis.py``) at the 3-point Gauss rule
    (``fem/quadrature.py``): V, D (Q2 values and derivatives, [q, n]), Vp
    (Q1 values, [q, m]); VW, DW, VpW the same times the weights w[q]
    (projection axes 1..d-1) and VW0, DW0, VpW0 times det J * w[q] (axis
    0); Jinv padded to 3 x 3.  ``pack_1d_tables`` lays them out for the
    kernel."""
    x, w = gauss_legendre_1d(3)
    q2, q1 = LagrangeBasis1D(2), LagrangeBasis1D(1)
    V, D, Vp = q2.eval(x), q2.eval(x, 1), q1.eval(x)
    Jpad = np.zeros((3, 3))
    Jpad[:dim, :dim] = Jinv
    wd = w * detJ
    return dict(V=V, D=D, Vp=Vp, VW=V * w[:, None], DW=D * w[:, None],
                VpW=Vp * w[:, None], VW0=V * wd[:, None],
                DW0=D * wd[:, None], VpW0=Vp * wd[:, None], Jinv=Jpad)


_TABLE_ORDER = ("V", "D", "Vp", "VW", "DW", "VpW", "VW0", "DW0", "VpW0",
                "Jinv")


def pack_1d_tables(tab: dict) -> np.ndarray:
    """The 81 float32 of ``Tables`` in ``csrc/gd_lattice.cu``."""
    out = np.concatenate([np.asarray(tab[k]).reshape(-1)
                          for k in _TABLE_ORDER]).astype(np.float32)
    assert out.size == TABLE_FLOATS
    return out


def dense_from_1d(dim: int, tab: dict):
    """(Tv, Pv, Tp, Pp) rebuilt from the 1D tables by tensor products, in
    the lexicographic order of the nodes and points (axis 0 fastest): the
    dense tables that the kernel's passes apply."""
    d = dim

    def kron(mats):            # axis 0 fastest: the last factor varies first
        out = np.ones((1, 1))
        for m in reversed(mats):
            out = np.kron(out, m)
        return out

    V, D, Vp = tab["V"], tab["D"], tab["Vp"]
    Jinv = tab["Jinv"][:d, :d]
    Bv = kron([V] * d)
    Gref = [kron([D if b == a else V for b in range(d)]) for a in range(d)]
    Gphys = [sum(Gref[a] * Jinv[a, i] for a in range(d)) for i in range(d)]
    Tv = np.concatenate([Bv] + Gphys, axis=0)
    Tp = kron([Vp] * d)
    # the weighted tables: det J * w on axis 0, w on the others
    W = kron([tab["VW0"]] + [tab["VW"]] * (d - 1))
    Wg = [sum(kron([(tab["DW0"] if a == 0 else tab["VW0"])]
                   + [(tab["DW"] if b == a else tab["VW"])
                      for b in range(1, d)]) * Jinv[a, i]
              for a in range(d)) for i in range(d)]
    Pv = np.concatenate([W] + Wg, axis=0).T
    Pp = kron([tab["VpW0"]] + [tab["VpW"]] * (d - 1)).T
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


def route_for(dim: int, n_elements: int, n_sms: int,
              route: str = "auto") -> int:
    """The route of one launch: ``route`` "auto" takes REGISTERS from
    ``REG_MIN_PER_SM`` elements per SM on where the dim has it (2D);
    "staged" or "registers" forces one (``persistent_tiles.choose_route``;
    3D stays STAGED)."""
    return pt.choose_route(route, dim in REGISTER_DIMS, n_elements,
                           REG_MIN_PER_SM, n_sms)


def tile_config(dim: int, mode: int, route: int = pt.STAGED) -> dict:
    """The shape of one variant's launch, as ``Shape<D, MODE>`` in
    ``csrc/gd_lattice.cu`` computes it: elements per tile ``be`` (per
    block on the REGISTERS route), threads per block, the input rows of a
    ring stage (ue, due, vpe, fq) and the shared-memory bytes (two
    stages, then the scratch rows S0 and S1 per element); REGISTERS uses
    none."""
    nnv, nnp = 3 ** dim, 2 ** dim
    rs = dim * nnv + nnp
    tan = mode == _TANGENT
    rows = (rs, rs if tan else 0, 0 if tan else dim * nnv,
            0 if tan else dim * nnv)
    if route == pt.REGISTERS:
        return dict(be=REG_THREADS, threads=REG_THREADS, rows=rows,
                    smem_bytes=0)
    be = STAGED_BE
    s0, s1 = (78, 42) if dim == 2 else (261, 261)
    floats = pt.STAGES * pt.stage_floats(rows, be) + (s0 + s1) * be
    return dict(be=be, threads=nnv // 3 * be, rows=rows,
                smem_bytes=4 * floats)


def config_on_card(dim: int, mode: int, route: int) -> tuple[int, int, int]:
    """(blocks per SM, shared-memory bytes, threads) of one variant, from
    the compiled library (cached)."""
    key = (dim, 1, mode, route)
    if key not in _CONFIG:
        out = [ctypes.c_int() for _ in range(3)]
        err = get_build().lib.gd_lattice_config(
            *key, *(ctypes.byref(o) for o in out))
        if err != 0:
            raise RuntimeError(f"GD lattice kernel {key}: CUDA error {err}")
        _CONFIG[key] = tuple(o.value for o in out)
    return _CONFIG[key]


class LatticeGDKernel(nn.Module):
    """Residual and exact tangent of the GD weak form on a lattice of
    translates of the velocity element ``xe0`` [nnv, d].

    ``launches`` counts CUDA kernel launches (class-wide), and
    ``launches_by_shape`` the same per (dim, velocity degree, points per
    axis, E, variant, route); the plain version on CPU tensors does not
    count.
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
        self.q1d = round(self.nq ** (1 / dim))
        self.supported = ((dim, degree_pressure, self.q1d) in SUPPORTED
                          and self.q1d ** dim == self.nq)
        # the CUDA kernel's 1D tables and J^-1, in host memory (they go
        # into the kernel's parameters); it takes them only where their
        # tensor products are this operator's dense tables
        self.geometry = affine_geometry(xe0, Gv)      # (J^-1, det J)
        self._host_tables = None
        if self.supported:
            tab = gd_1d_tables(dim, *self.geometry)
            scale = max(np.abs(t).max() for t in tables)
            if all(np.abs(a - b).max() <= 1e-12 * scale
                   for a, b in zip(dense_from_1d(dim, tab), tables)):
                self._host_tables = pack_1d_tables(tab)
        self._plans = {}

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

    def _call(self, mode, ue, due, vpe, fq, alpha0, route="auto"):
        """One variant on CUDA tensors with a forced ``route``; the
        solvers leave the route to the launch plan."""
        out = torch.empty_like(ue)
        self._launch(mode, ue, due, vpe, fq, out, alpha0, route)
        return out

    # ------------------------------------------------------------------
    def _plan(self, mode, E, device, route):
        """(route, grid) of a launch on E elements, cached per variant, E
        and forced route: the host cost of a launch is most of a small
        kernel's time."""
        key = (mode, E, route)
        if key not in self._plans:
            if not self.supported:
                raise ValueError(
                    f"CUDA GD lattice kernel: no variant for dim={self.dim}, "
                    f"pressure degree={self.degree_pressure} with {self.nq} "
                    "quadrature points (compiled: Q2-Q1 in 2D/3D with 3 "
                    "points per axis)")
            if self._host_tables is None:
                raise ValueError(
                    "CUDA GD lattice kernel: the basis tables are not the "
                    "tensor products of the Q2/Q1 Lagrange bases at the "
                    "3-point Gauss rule")
            n_sms = pt.sm_count(device)
            r = route_for(self.dim, E, n_sms, route)
            grid = pt.persistent_grid(
                E, tile_config(self.dim, mode, r)["be"],
                config_on_card(self.dim, mode, r)[0], n_sms)
            self._plans[key] = (r, grid)
        return self._plans[key]

    def _launch(self, mode, ue, due, vpe, fq, out, alpha0, route="auto"):
        d = self.dim
        E = ue.shape[-1]
        expect = [(ue, (self.rows, E)), (out, (self.rows, E))]
        if mode == _TANGENT:
            expect.append((due, (self.rows, E)))
        else:
            expect += [(vpe, (d * self.nnv, E)), (fq, (d * self.nq, E))]
        dev = ue.get_device()
        for t, shape in expect:
            if (t.shape != shape or t.dtype != torch.float32
                    or t.get_device() != dev or not t.is_contiguous()):
                raise ValueError(
                    "CUDA GD lattice kernel takes contiguous float32 "
                    f"tensors on {ue.device}: got {tuple(t.shape)} "
                    f"{t.dtype} on {t.device} where {shape} was expected")
        r, grid = self._plan(mode, E, dev, route)
        ptrs = [t.data_ptr() for t, _ in expect if t is not out]
        err = get_build().lib.gd_lattice_launch(
            d, self.degree_pressure, mode, ptrs[0],
            due.data_ptr() if due is not None else None,
            vpe.data_ptr() if vpe is not None else None,
            fq.data_ptr() if fq is not None else None,
            self._host_tables.ctypes.data, out.data_ptr(), E, self.nu,
            self.gamma, float(alpha0), r, grid, pt.load_path(E, ptrs),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"GD lattice kernel launch failed: CUDA "
                               f"error {err}")
        cls = LatticeGDKernel
        cls.launches += 1
        key = (d, self.degree_pressure + 1, self.q1d, E, MODES[mode],
               ROUTE_NAMES[r])
        cls.launches_by_shape[key] = cls.launches_by_shape.get(key, 0) + 1
