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
  the frozen-tau linearization, as B2's; the tangent and the probes also
  take bf16 state rows, and a module built with ``dtype=torch.bfloat16``
  launches the bf16-operand instances, see below);
- anything else raises.  There is no fallback from CUDA to the plain
  version, nor from a bf16 instance to a float32 one.

The tangent and the node-block probes take the frozen state (ue, up, fq)
in float32 or in bf16 (``jacobian state precision = bf16``, rows from
``persistent_tiles.state_rows``), as B2 does with
``state_dtype=bfloat16``: the rows are stored rounded, every element is
widened to float32 where it is read, and the contractions with T_all and
T_proj, the direction and the output stay float32 (B2's one-pass bf16
product on the TPU's matrix unit is a rate trick of that chip, not
ported).  On the CPU a bf16 state is widened to the compute dtype and
differentiated with tau frozen, as B2 computes it.

A module built with ``dtype=torch.bfloat16`` is B2 with a bf16 compute
dtype (``pallas_lattice.py:124-128``, ``:253-258``): the rows ue, due, up
and fq and the tables T_all and T_proj are bf16 (rounded once, here, from
the float64 tables; packed for the kernel, and for the REGISTERS route in
host memory, as bf16), every product and the pointwise physics run in
float32, and the output is rounded once to bf16 (round to nearest even)
where it is stored, at the rows' pitch.  All three modes have such an
instance ("primal_bf16op", "tangent_bf16op", "probe_bf16op" in
``launches_by_shape``); the tangent freezes tau, as on float32.  Its
plain version, the CPU path of such a module and the card's yardstick,
is defined the same way: the bf16 operands widened to float32, the
float32 plain kernel (tau frozen for the tangent and the probes), the
output rounded to bf16.

A launch is a persistent grid (``ops/persistent_tiles.py``) on one of two
routes, chosen per launch from the shape, E and the tables
(``route_for``): STAGED (every shape: tiles of rows through a
shared-memory ring, then one thread per point and one per node) or
REGISTERS (Q1 with 2 points per axis on a lattice of boxes: one thread
per element, the tables in the kernel's parameters).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import os

import numpy as np
import torch
from torch import nn

from . import cuda_build
from . import persistent_tiles as pt
from .batched_kernel import probe_chunks

SOURCE = os.path.join(cuda_build.CSRC, "gls_lattice.cu")

_PRIMAL, _TANGENT, _PROBE = 0, 1, 2
MODES = ("primal", "tangent", "probe")
# the variants that take bf16 state rows (float32 direction, tables and
# output); every mode has a bf16-operand instance
BF16_MODES = (_TANGENT, _PROBE)
# the compute dtypes of a module: float32, or every operand in bf16
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
REG_THREADS = 128          # REGISTERS: one thread per element
# (dim, degree, Gauss points per axis): Q1/Q2 with degree + 1 points, and
# Q1 with 3, which the Q1 multigrid levels of a Q2 deck use
SUPPORTED = {(2, 1, 2), (2, 2, 3), (3, 1, 2), (3, 2, 3), (2, 1, 3),
             (3, 1, 3)}
# the shapes with a REGISTERS route: Q1 with 2 points per axis
REGISTER_SHAPES = {(2, 1, 2), (3, 1, 2)}
# a launch takes REGISTERS from this many elements per SM on, STAGED
# below (chosen by measurement: PERF.md)
REG_MIN_PER_SM = 128

_BUILD: cuda_build.KernelBuild | None = None
_CONFIG: dict = {}


def get_build() -> cuda_build.KernelBuild:
    """The process's compiled lattice-kernel library, built at first
    call."""
    global _BUILD
    if _BUILD is None:
        _BUILD = cuda_build.load(
            SOURCE, "gls_lattice_launch",
            [ctypes.c_int] * 6 + [ctypes.c_void_p] * 7
            + [ctypes.c_int64] * 2 + [ctypes.c_float] * 4
            + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        _BUILD.lib.gls_lattice_config.restype = ctypes.c_int
        _BUILD.lib.gls_lattice_config.argtypes = (
            [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)] * 3)
    return _BUILD


def route_for(dim: int, degree: int, n_q1d: int, n_elements: int,
              n_sms: int, laplacian_free: bool, route: str = "auto") -> int:
    """The route of one launch: ``route`` "auto" takes REGISTERS from
    ``REG_MIN_PER_SM`` elements per SM on where the shape has it; "staged"
    or "registers" forces one (``persistent_tiles.choose_route``).  The
    REGISTERS route leaves out the Laplacian rows of the tables, so it
    needs them zero (``laplacian_free``: Q1 on a lattice of boxes, not on
    a sheared one)."""
    return pt.choose_route(
        route, (dim, degree, n_q1d) in REGISTER_SHAPES and laplacian_free,
        n_elements, REG_MIN_PER_SM, n_sms)


def tile_config(dim: int, degree: int, n_q1d: int, mode: int,
                route: int = pt.STAGED, state_bytes: int = 4,
                operand_bytes: int = 4) -> dict:
    """The shape of one variant's launch, as ``Shape<D, K, Q, MODE, SE,
    OE>`` in ``csrc/gls_lattice.cu`` computes it: elements per tile ``be``
    (per block on the REGISTERS route), threads per block, the input rows
    of a ring stage (ue, due, up, fq), their bytes per element (the
    state's ``state_bytes``; due's ``operand_bytes``, like the tables')
    and the shared-memory bytes (tables, two stages, the staged
    coefficients); REGISTERS uses none."""
    nn, nq = (degree + 1) ** dim, n_q1d ** dim
    c = dim + 1
    rows = (c * nn, c * nn if mode == _TANGENT else 0, dim * nn, dim * nq)
    sb, ob = state_bytes, operand_bytes
    elem_bytes = (sb, ob, sb, sb)
    if route == pt.REGISTERS:
        return dict(be=REG_THREADS, threads=REG_THREADS, rows=rows,
                    elem_bytes=elem_bytes, smem_bytes=0)
    M, Mnl = (dim + 2) * nq, (dim + 1) * nq
    slots = max(nq, nn)
    be = 32 if slots * 32 <= 512 else 16
    floats = (pt.table_words(2 * M * nn, ob)
              + pt.STAGES * pt.stage_floats(rows, be, elem_bytes)
              + (dim * M + Mnl) * be)
    return dict(be=be, threads=slots * be, rows=rows, elem_bytes=elem_bytes,
                smem_bytes=4 * floats)


def config_on_card(dim: int, degree: int, n_q1d: int, mode: int,
                   route: int, state_bytes: int = 4,
                   operand_bytes: int = 4) -> tuple[int, int, int]:
    """(blocks per SM, shared-memory bytes, threads) of one variant with
    state rows of ``state_bytes`` and a direction, tables and output of
    ``operand_bytes``, from the compiled library (cached)."""
    key = (dim, degree, n_q1d, mode, route, state_bytes, operand_bytes)
    if key not in _CONFIG:
        out = [ctypes.c_int() for _ in range(3)]
        err = get_build().lib.gls_lattice_config(
            dim, degree, n_q1d, mode, state_bytes, operand_bytes, route,
            *(ctypes.byref(o) for o in out))
        if err != 0:
            raise RuntimeError(f"GLS lattice kernel {key}: CUDA error {err}")
        _CONFIG[key] = tuple(o.value for o in out)
    return _CONFIG[key]


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
        # the time derivative from its nodal values (alpha0 u + combo,
        # a small difference of two large terms) and not from alpha0 times
        # the interpolated u: the float32 rounding stays that of the
        # small result
        udot = torch.einsum("qn,inE->iqE", T_all[:nq],
                            (alpha0 * ue[:d * nn] + up).reshape(d, nn, E))
        f = fq.reshape(d, nq, E)

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
    nn*c forward-mode probes, vectorised as ``node_blocks_batched``
    does."""
    cn, E = ue.shape
    c = cn // nn
    out = ue.new_empty((nn, c, c, E))                        # [n, i, j, E]
    tangent = torch.func.vmap(lambda p: lattice_tangent(
        kernel, ue, p, up, fq, alpha0, sdt))
    for k in probe_chunks(nn * c, E, ue.device):
        n0, j, m = k // c, k % c, torch.arange(len(k), device=ue.device)
        probes = ue.new_zeros((len(k), cn, E))
        probes[m, j * nn + n0] = 1.0
        out[n0, :, j] = tangent(probes).reshape(len(k), c, nn, E)[m, :, n0]
    return out.reshape(nn, c * c, E)


class LatticeGLSKernel(nn.Module):
    """Residual, tangent and node-block probes of the GLS weak form on a
    lattice of translates of the element ``xe0`` [nn, d].

    ``launches`` counts CUDA kernel launches (class-wide), and
    ``launches_by_shape`` the same per (dim, degree, points per axis, E,
    variant: "tangent_bf16" and "probe_bf16" for bf16 state,
    "primal_bf16op", "tangent_bf16op" and "probe_bf16op" for bf16
    operands); the plain version on CPU tensors does not count.
    ``dtype`` is the compute dtype: on the card float32, or bfloat16 for
    the bf16-operand instances; any dtype on the CPU.
    """

    launches = 0
    launches_by_shape: dict = {}

    def __init__(self, *, dim: int, degree: int, B, G, H, w, xe0,
                 nu: float, stab, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        super().__init__()
        if torch.device(device).type == "cuda" and dtype not in KERNEL_DTYPES:
            raise ValueError(f"CUDA GLS lattice kernel: no instance takes "
                             f"{dtype} (compiled: {KERNEL_DTYPES})")
        self.dim, self.degree = dim, degree
        self.nc = dim + 1
        self.nq, self.nn = B.shape
        self.nu = float(nu)
        self.stab = stab
        # the operands' bytes, and the dtype the plain version computes in
        self._ob = 2 if dtype == torch.bfloat16 else 4
        self._wide = torch.float32 if self._ob == 2 else dtype
        T, P, h, _ = affine_tables(
            dim, self.nn, self.nq, B, G,
            np.asarray(H).reshape(self.nq, self.nn, dim, dim), w, xe0,
            degree)
        self.h = h
        # the basis Laplacians vanish, up to the rounding of J^-1 (Q1 on a
        # lattice of boxes; not on a sheared one): the REGISTERS route
        # relies on it, and its launch is refused without it
        self.laplacian_free = bool(np.abs(T[(dim + 1) * self.nq:]).max()
                                   <= 1e-12 * np.abs(T).max())
        self.register_buffer("T_all", torch.as_tensor(T, dtype=dtype,
                                                      device=device))
        self.register_buffer("T_proj", torch.as_tensor(P, dtype=dtype,
                                                       device=device))
        # packed tables for the CUDA kernel, in the operand type (float32,
        # or the bf16 T_all and T_proj above): T_all then T_proj, each
        # row-major; the REGISTERS route takes them from the host copy
        packed = np.concatenate([T.reshape(-1), P.reshape(-1)])
        if self._ob == 2:
            self._host_tables = torch.cat([self.T_all.reshape(-1),
                                           self.T_proj.reshape(-1)]).cpu()
            self._host_tables_ptr = self._host_tables.data_ptr()
        else:
            self._host_tables = packed.astype(np.float32)
            self._host_tables_ptr = self._host_tables.ctypes.data
        self.register_buffer("tables", torch.as_tensor(
            self._host_tables, device=device))
        self._plain_cache = {}
        # launch plans: per kernel, since the route follows its tables
        self._plans = {}
        self._flags = tuple(int(f) for f in (stab.supg, stab.pspg,
                                              stab.gls_viscous_adjoint,
                                              stab.lsic))
        self.q1d = round(self.nq ** (1 / dim))

    def plain(self, stab=None):
        """The plain PyTorch kernel on this module's device, in its dtype
        (float32 on bf16 tables widened, for a bf16 module) (``stab``
        overrides the stabilization flags, e.g. frozen tau)."""
        stab = stab or self.stab
        key = (stab, self.T_all.dtype, self.T_all.device)
        if key not in self._plain_cache:
            self._plain_cache[key] = make_lattice_kernel(
                dim=self.dim, nn=self.nn, nq=self.nq,
                T_all=self.T_all.to(self._wide),
                T_proj=self.T_proj.to(self._wide), h=self.h, nu=self.nu,
                stab=stab)
        return self._plain_cache[key]

    def _on_cuda(self, ue) -> bool:
        if ue.device.type == "cpu":
            return False
        if ue.device.type != "cuda":
            raise ValueError(f"no GLS lattice kernel for device {ue.device}")
        return True

    def _plain_state(self, state):
        """The plain kernel and the state rows it reads: a bf16 state
        widened to the compute dtype (float32 for a bf16 module), with tau
        frozen (B2's linearization of a bf16 state, and the bf16-operand
        tangent's)."""
        if state[0].dtype != torch.bfloat16:
            return self.plain(), state
        frozen = dataclasses.replace(self.stab, frozen_tau=True)
        return self.plain(frozen), [t.to(self._wide) for t in state]

    def _rounded(self, x):
        """A plain result in the module's output type: rounded once to
        bf16 for a bf16 module."""
        return x.to(torch.bfloat16) if self._ob == 2 else x

    # the plain version of each mode, on any device: the CPU path, and on
    # the card the yardstick of the kernel (chip_smoke.py)
    def plain_residual(self, ue, up, fq, alpha0, sdt):
        return self._rounded(self.plain()(
            *(t.to(self._wide) for t in (ue, up, fq)), alpha0, sdt))

    def plain_tangent(self, ue, due, up, fq, alpha0, sdt):
        kernel, (ue, up, fq) = self._plain_state((ue, up, fq))
        return self._rounded(lattice_tangent(
            kernel, ue, due.to(self._wide), up, fq, alpha0, sdt))

    def plain_node_blocks(self, ue, up, fq, alpha0, sdt):
        kernel, (ue, up, fq) = self._plain_state((ue, up, fq))
        return self._rounded(lattice_node_blocks(kernel, ue, up, fq, alpha0,
                                                 sdt, self.nn))

    # ------------------------------------------------------------------
    def residual(self, ue, up, fq, alpha0, sdt):
        """r[c*nn, E]: the element residuals (full tau)."""
        if not self._on_cuda(ue):
            return self.plain_residual(ue, up, fq, alpha0, sdt)
        out = pt.launch_output(ue, ue.shape, self._ob)
        self._launch(_PRIMAL, ue, None, (up, fq, alpha0, sdt), out)
        return out

    def tangent(self, ue, due, up, fq, alpha0, sdt):
        """dr[c*nn, E] along ``due``: exact or frozen tau per the flags on
        CPU (frozen for a bf16 state or bf16 operands); frozen tau on
        CUDA."""
        if not self._on_cuda(ue):
            return self.plain_tangent(ue, due, up, fq, alpha0, sdt)
        out = pt.launch_output(ue, due.shape, self._ob)
        self._launch(_TANGENT, ue, due, (up, fq, alpha0, sdt), out)
        return out

    def node_blocks(self, ue, up, fq, alpha0, sdt):
        """Element node-diagonal Jacobian blocks [nn, c*c, E] (row-major
        (i, j)): on CUDA one probe launch per (node, component)."""
        if not self._on_cuda(ue):
            return self.plain_node_blocks(ue, up, fq, alpha0, sdt)
        return self._call(_PROBE, ue, None, (up, fq, alpha0, sdt))


    # ------------------------------------------------------------------
    def _call(self, mode, ue, due, args, route="auto"):
        """One variant on CUDA tensors, ``args`` = (up, fq, alpha0, sdt):
        out [c*nn, E], or for the probe the node blocks [nn, c*c, E] from
        nn*c launches.  ``route`` forces a route; the solvers leave it to
        the launch plan."""
        if mode != _PROBE:
            out = pt.launch_output(ue, ue.shape, self._ob)
            self._launch(mode, ue, due, args, out, (0, 0), route)
            return out
        c, E = self.nc, ue.shape[-1]
        out = pt.launch_output(ue, (self.nn, c * c, E), self._ob)
        for n0 in range(self.nn):
            for j in range(c):
                self._launch(_PROBE, ue, None, args, out, (n0, j), route)
        return out

    def _plan(self, mode, q1d, E, device, route, sb=4):
        """(route, grid) of a launch on E elements, cached per variant,
        state bytes ``sb``, E and forced route (the device is the
        tables', the operand type the module's): the host cost of a
        launch is most of a small kernel's time, and the bf16 variants
        have their own registers, shared memory and occupancy."""
        key = (mode, E, route, sb)
        if key not in self._plans:
            d, k = self.dim, self.degree
            if (d, k, q1d) not in SUPPORTED or q1d ** d != self.nq:
                raise ValueError(
                    f"CUDA GLS lattice kernel: no variant for dim={d}, "
                    f"degree={k} with {self.nq} quadrature points "
                    f"(compiled: Q1/Q2 in 2D/3D with degree+1 points per "
                    f"axis, and Q1 with 3)")
            n_sms = pt.sm_count(device)
            r = route_for(d, k, q1d, E, n_sms, self.laplacian_free, route)
            op = {"operand_bytes": 2} if self._ob == 2 else {}
            grid = pt.persistent_grid(
                E, tile_config(d, k, q1d, mode, r, sb, **op)["be"],
                config_on_card(d, k, q1d, mode, r, sb, **op)[0], n_sms)
            self._plans[key] = (r, grid)
        return self._plans[key]

    def _launch(self, mode, ue, due, args, out, probe=(0, 0), route="auto"):
        up, fq, alpha0, sdt = args
        d, nn, nq, c, q1d = self.dim, self.nn, self.nq, self.nc, self.q1d
        E = ue.shape[-1]
        sb, ob = pt.state_bytes(ue), self._ob
        if ob == 2 and sb != 2:
            raise ValueError(f"CUDA GLS lattice kernel with bf16 operands: "
                             f"got {ue.dtype} rows")
        if sb != 4 and ob == 4 and mode not in BF16_MODES:
            raise ValueError("CUDA GLS lattice kernel: bf16 state rows are "
                             "taken by the tangent and the probes only")
        state = [(ue, (c * nn, E)), (up, (d * nn, E)), (fq, (d * nq, E))]
        other = [(out, out.shape), (self.tables, self.tables.shape)]
        if due is not None:
            other.append((due, (c * nn, E)))
        dev = ue.get_device()
        # bf16 operands: every tensor is bf16 at the state rows' pitch
        pitch = (pt.check_rows("GLS lattice", dev, state + other, [])
                 if ob == 2 else
                 pt.check_rows("GLS lattice", dev, state, other))
        route, grid = self._plan(mode, q1d, E, dev, route, sb)
        ptrs = [t.data_ptr() for t in (ue, up, fq)]
        pitch_bytes = [sb * pitch]
        if due is not None:
            ptrs.append(due.data_ptr())
            pitch_bytes.append(2 * pitch if ob == 2 else 4 * E)
        err = get_build().lib.gls_lattice_launch(
            d, self.degree, q1d, mode, sb, ob, ptrs[0],
            ptrs[3] if due is not None else None, ptrs[1], ptrs[2],
            self.tables.data_ptr(), self._host_tables_ptr, out.data_ptr(), E,
            pitch, self.nu, self.h, float(alpha0), float(sdt), *self._flags,
            probe[0], probe[1], route, grid,
            pt.load_path(E, ptrs, pitch_bytes), int(self.laplacian_free),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"GLS lattice kernel launch failed: CUDA "
                               f"error {err}")
        cls = LatticeGLSKernel
        cls.launches += 1
        key = (d, self.degree, q1d, E, MODES[mode] + (
            "_bf16op" if ob == 2 else "_bf16" if sb == 2 else ""))
        cls.launches_by_shape[key] = cls.launches_by_shape.get(key, 0) + 1
