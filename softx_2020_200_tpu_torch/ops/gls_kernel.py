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
  frozen-tau linearization (as B1's); float32, and for the tangent and
  the probes also bf16 state rows; a module built with
  ``dtype=torch.bfloat16`` launches the bf16-operand instances (see
  below);
- anything else raises.  There is no fallback from CUDA to the plain
  version, nor from a bf16 instance to a float32 one.

The tangent and the node-block probes take the frozen state (ue, xe, up,
fq, h) in float32 or in bf16 (``jacobian state precision = bf16``, rows
from ``persistent_tiles.state_rows``), as B1 does with
``state_dtype=bfloat16``: the rows are stored rounded, every element is
widened to float32 where it is read, and the direction, the arithmetic
and the output stay float32.  On the CPU a bf16 state is widened to the
compute dtype and differentiated with tau frozen, which is what B1
computes (``pallas_gls.py:287-295``).

A module built with ``dtype=torch.bfloat16`` is B1 with a bf16 compute
dtype (``pallas_gls.py:220``, ``:241-245``, ``:397``): bf16 storage of
every operand (the rows ue, due, xe, up, fq and h, the tables B, G, H and
w, rounded once here) and of the output, rounded once to bf16 (round to
nearest even) where it is stored, at the rows' pitch; float32 arithmetic
inside.  B1 computes in bf16 op by op, a rounding sequence no second
compiler reproduces; float32 inside lands between the JAX package's bf16
and float32 results, a difference of rounding and not of function.  All
three modes have such an instance ("primal_bf16op", "tangent_bf16op",
"probe_bf16op" in ``launches_by_shape``).  Its plain version, the CPU path
of such a module and the card's yardstick, is defined the same way: the
bf16 operands widened to float32, the float32 plain kernel (tau frozen for
the tangent and the probes), the output rounded to bf16.

The kernel is compiled by ``nvcc`` from ``csrc/gls_element.cu`` at first
use into ``build/`` next to this package, and loaded with ``ctypes``
(``ops/cuda_build.py``).  A launch is a persistent grid
(``ops/persistent_tiles.py``) on one of two routes, chosen per launch
from the shape and E (``route_for``): STAGED (tiles of rows through a
shared-memory ring, one thread per quadrature point, then one per node)
or REGISTERS (one, two or four threads per element, on the shapes whose
state fits the registers).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import numpy as np
import torch
from torch import nn

from . import cuda_build
from . import persistent_tiles as pt
from .batched_kernel import (make_batched_kernel, node_blocks_batched,
                             tangent_batched)

SOURCE = os.path.join(cuda_build.CSRC, "gls_element.cu")

_PRIMAL, _TANGENT, _PROBE = 0, 1, 2
MODES = ("primal", "tangent", "probe")
# the variants that take bf16 state rows (float32 direction, tables and
# output); every mode has a bf16-operand instance
BF16_MODES = (_TANGENT, _PROBE)
# the compute dtypes of a module on the card: float32, or every operand in
# bf16
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# (dim, degree) with degree + 1 Gauss points per axis
SUPPORTED = {(2, 1), (2, 2), (3, 1), (3, 2)}
# (dim, degree, points per axis) of the other compiled rules, on the
# STAGED route only: Q1 with 3 points, the levels below a Q2 mesh's Q1
# p-level in the forest multigrid (ops/multigrid.py)
OTHER_POINTS = {(2, 1, 3), (3, 1, 3)}
# the shapes with a REGISTERS route (one thread per element; 3D Q2's state
# does not fit the registers), and its threads per block
REGISTER_SHAPES = {(2, 1), (2, 2), (3, 1)}
REG_THREADS = 64
# the compiled threads per element of the REGISTERS route, per dim (a
# launch takes the largest that fits the card at once,
# ``persistent_tiles.split_for``: at the Taylor-Couette shape, 2 for the
# tangent and 4 for the primal and the probe)
REG_SPLITS = {2: (1, 2, 4), 3: (1,)}
# a launch takes REGISTERS from this many elements per SM on, STAGED
# below (chosen by measurement: PERF.md)
REG_MIN_PER_SM = 64

_BUILD: cuda_build.KernelBuild | None = None
_CONFIG: dict = {}


def get_build() -> cuda_build.KernelBuild:
    """The process's compiled kernel library, built at first call."""
    global _BUILD
    if _BUILD is None:
        _BUILD = cuda_build.load(
            SOURCE, "gls_element_launch",
            [ctypes.c_int] * 6 + [ctypes.c_void_p] * 8
            + [ctypes.c_int64] * 2 + [ctypes.c_float] * 3
            + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        _BUILD.lib.gls_element_config.restype = ctypes.c_int
        _BUILD.lib.gls_element_config.argtypes = (
            [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)] * 3)
    return _BUILD


def route_for(dim: int, degree: int, n_elements: int, n_sms: int,
              route: str = "auto") -> int:
    """The route of one launch: ``route`` "auto" takes REGISTERS from
    ``REG_MIN_PER_SM`` elements per SM on where the shape has it;
    "staged" or "registers" forces one (``persistent_tiles.choose_route``)."""
    return pt.choose_route(route, (dim, degree) in REGISTER_SHAPES,
                           n_elements, REG_MIN_PER_SM, n_sms)


def tile_config(dim: int, degree: int, mode: int,
                route: int = pt.STAGED, split: int = 1,
                state_bytes: int = 4, points: int | None = None,
                operand_bytes: int = 4) -> dict:
    """The shape of one variant's launch, as ``csrc/gls_element.cu``
    computes it: elements per tile ``be`` (per block on the REGISTERS
    route, with ``split`` threads per element), threads per block (one
    per (point or node, element) on the STAGED route, the more of the
    two), the input rows of a ring stage (ue, due, xe, up, fq, h), their
    bytes per element (the state's ``state_bytes``; due's
    ``operand_bytes``, like the tables') and the shared-memory bytes
    (STAGED: tables, two stages, the staged coefficients of every point;
    REGISTERS: the tables).  ``points`` per axis: degree + 1 by
    default."""
    nn = (degree + 1) ** dim
    nq = (points or degree + 1) ** dim
    c, nh = dim + 1, dim * (dim + 1) // 2
    tables = nq * nn * (1 + dim + nh) + nq
    rows = (nn * c, nn * c if mode == _TANGENT else 0, nn * dim, nn * dim,
            nq * dim, 1)
    sb, ob = state_bytes, operand_bytes
    elem_bytes = (sb, ob, sb, sb, sb, sb)
    if route == pt.REGISTERS:
        return dict(be=REG_THREADS // split, threads=REG_THREADS,
                    rows=rows, elem_bytes=elem_bytes, smem_bytes=ob * tables)
    slots = max(nn, nq)
    be = 32 if slots * 32 <= 512 else 16
    ncoef = 3 * dim + dim * dim + 1 + nh
    floats = (pt.table_words(tables, ob)
              + pt.STAGES * pt.stage_floats(rows, be, elem_bytes)
              + nq * ncoef * be)
    return dict(be=be, threads=slots * be, rows=rows, elem_bytes=elem_bytes,
                smem_bytes=4 * floats)


def config_on_card(dim: int, degree: int, mode: int, route: int,
                   split: int = 1, state_bytes: int = 4,
                   points: int | None = None,
                   operand_bytes: int = 4) -> tuple[int, int, int]:
    """(blocks per SM, shared-memory bytes, threads) of one variant (with
    ``split`` threads per element on the REGISTERS route, state rows of
    ``state_bytes``, a direction, tables and output of ``operand_bytes``
    and ``points`` Gauss points per axis, degree + 1 by default), from the
    compiled library (cached)."""
    points = points or degree + 1
    key = (dim, degree, points, mode, route, split, state_bytes,
           operand_bytes)
    if key not in _CONFIG:
        out = [ctypes.c_int() for _ in range(3)]
        err = get_build().lib.gls_element_config(
            dim, degree, points, mode, state_bytes, operand_bytes, route,
            split, *(ctypes.byref(o) for o in out))
        if err != 0:
            raise RuntimeError(f"GLS element kernel {key}: CUDA error {err}")
        _CONFIG[key] = tuple(o.value for o in out)
    return _CONFIG[key]


def symmetric_hessians(H, dim: int) -> np.ndarray:
    """Hs[q, n, k] from H[q, n, a, b] over the pairs a <= b (row-major),
    off-diagonal pairs summed, so that sum_ab H[a, b] K[a, b] is
    sum_k Hs[k] K[a_k, b_k] for a symmetric K."""
    H = np.asarray(H, np.float64).reshape(*np.shape(H)[:2], dim, dim)
    cols = [H[..., a, a] if a == b else H[..., a, b] + H[..., b, a]
            for a in range(dim) for b in range(a, dim)]
    return np.stack(cols, axis=-1)


class GLSElementKernel(nn.Module):
    """Residual, tangent and node-block probes of the GLS element
    kernel, on the SoA rows ``ue[nn, c, E]``, ``xe[nn, d, E]``,
    ``up[nn, d, E]``, ``fq[q, d, E]``, ``h[E]``.

    ``launches`` counts CUDA kernel launches (class-wide), and
    ``launches_by_shape`` the same per (dim, degree, points per axis, E,
    variant: "tangent_bf16" and "probe_bf16" for bf16 state,
    "primal_bf16op", "tangent_bf16op" and "probe_bf16op" for bf16
    operands); the plain version on CPU tensors does not count.  The rule
    is the tables' (nq points): degree + 1 points per axis, or for Q1 also
    3.  ``dtype`` is the compute dtype: on the card float32, or bfloat16
    for the bf16-operand instances; any dtype on the CPU.
    """

    launches = 0
    launches_by_shape: dict = {}

    def __init__(self, *, dim: int, degree: int, B, G, H, w, nu: float,
                 stab, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        super().__init__()
        if torch.device(device).type == "cuda" and dtype not in KERNEL_DTYPES:
            raise ValueError(f"CUDA GLS kernel: no instance takes {dtype} "
                             f"(compiled: {KERNEL_DTYPES})")
        self.dim, self.degree = dim, degree
        self.nc = dim + 1
        self.nn, self.nq = B.shape[1], B.shape[0]
        self.q1d = round(self.nq ** (1 / dim))
        self.nu = float(nu)
        self.stab = stab
        # the operands' bytes, and the dtype the plain version computes in
        self._ob = 2 if dtype == torch.bfloat16 else 4
        self._wide = torch.float32 if self._ob == 2 else dtype
        for name, arr in (("B", B), ("G", G), ("H", H), ("w", w)):
            self.register_buffer(name, torch.as_tensor(
                np.array(arr), dtype=dtype, device=device))
        # packed tables for the CUDA kernel in the operand type: B[q, n],
        # G[q, n, a], the symmetric Hessians Hs[q, n, k], w[q], each
        # flattened q-major (for bf16, from the rounded tables above)
        tabs = ((B, G, H, w) if self._ob == 4 else
                [t.cpu().double().numpy() for t in (self.B, self.G, self.H,
                                                     self.w)])
        packed = np.concatenate([
            np.asarray(a, np.float64).reshape(-1)
            for a in (tabs[0], tabs[1], symmetric_hessians(tabs[2], dim),
                      tabs[3])])
        self.register_buffer("tables", torch.as_tensor(
            packed, dtype=torch.float32 if self._ob == 4 else dtype,
            device=device))
        self._plain_cache = {}
        self._plans = {}
        self._flags = tuple(int(f) for f in (stab.supg, stab.pspg,
                                              stab.gls_viscous_adjoint,
                                              stab.lsic))

    # ------------------------------------------------------------------
    def plain(self, stab=None):
        """The plain PyTorch kernel on this module's device, in its dtype
        (float32 on bf16 tables widened, for a bf16 module) (``stab``
        overrides the stabilization flags, e.g. frozen tau)."""
        stab = stab or self.stab
        key = (stab, self.B.dtype, self.B.device)
        if key not in self._plain_cache:
            self._plain_cache[key] = make_batched_kernel(
                dim=self.dim, B=self.B.to(self._wide),
                G=self.G.to(self._wide), H=self.H.to(self._wide),
                w=self.w.to(self._wide), nu=self.nu, stab=stab)
        return self._plain_cache[key]

    def _on_cuda(self, ue) -> bool:
        if ue.device.type == "cpu":
            return False
        if ue.device.type != "cuda":
            raise ValueError(f"no GLS element kernel for device {ue.device}")
        return True

    def _plain_state(self, state):
        """The plain kernel and the state rows it reads: a bf16 state
        widened to the compute dtype (float32 for a bf16 module), with tau
        frozen (B1's linearization of a bf16 state, and the bf16-operand
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
    def plain_residual(self, ue, xe, up, fq, h, alpha0, sdt):
        return self._rounded(self.plain()(
            *(t.to(self._wide) for t in (ue, xe, up, fq, h)), alpha0, sdt))

    def plain_tangent(self, ue, due, xe, up, fq, h, alpha0, sdt):
        kernel, state = self._plain_state((ue, xe, up, fq, h))
        return self._rounded(tangent_batched(
            kernel, state[0], due.to(self._wide), *state[1:], alpha0, sdt))

    def plain_node_blocks(self, ue, xe, up, fq, h, alpha0, sdt):
        kernel, state = self._plain_state((ue, xe, up, fq, h))
        return self._rounded(node_blocks_batched(kernel, *state, alpha0,
                                                 sdt))

    # ------------------------------------------------------------------
    def residual(self, ue, xe, up, fq, h, alpha0, sdt):
        """r[nn, c, E]: the element residuals (full tau)."""
        if not self._on_cuda(ue):
            return self.plain_residual(ue, xe, up, fq, h, alpha0, sdt)
        out = pt.launch_output(ue, ue.shape, self._ob)
        self._launch(_PRIMAL, ue, None, (xe, up, fq, h, alpha0, sdt), out)
        return out

    def tangent(self, ue, due, xe, up, fq, h, alpha0, sdt):
        """dr[nn, c, E] along ``due``: exact or frozen tau per the flags
        on CPU (frozen for a bf16 state or bf16 operands); frozen tau on
        CUDA."""
        if not self._on_cuda(ue):
            return self.plain_tangent(ue, due, xe, up, fq, h, alpha0, sdt)
        out = pt.launch_output(ue, due.shape, self._ob)
        self._launch(_TANGENT, ue, due, (xe, up, fq, h, alpha0, sdt), out)
        return out

    def node_blocks(self, ue, xe, up, fq, h, alpha0, sdt):
        """Element node-diagonal Jacobian blocks [nn, c*c, E] (row-major
        (i, j)): on CUDA one probe launch per (node, component)."""
        if not self._on_cuda(ue):
            return self.plain_node_blocks(ue, xe, up, fq, h, alpha0, sdt)
        return self._call(_PROBE, ue, None, (xe, up, fq, h, alpha0, sdt))


    # ------------------------------------------------------------------
    def _call(self, mode, ue, due, args, route="auto", split=None):
        """One variant on CUDA tensors, ``args`` = (xe, up, fq, h, alpha0,
        sdt): out [nn, c, E], or for the probe the node blocks
        [nn, c*c, E] from nn*c launches.  ``route`` and ``split`` force a
        route and its threads per element (None: the largest that fits);
        the solvers leave both to the launch plan."""
        nn, c, E = ue.shape
        if mode != _PROBE:
            out = pt.launch_output(ue, ue.shape, self._ob)
            self._launch(mode, ue, due, args, out, (0, 0), route, split)
            return out
        out = pt.launch_output(ue, (nn, c * c, E), self._ob)
        for n0 in range(nn):
            for j in range(c):
                self._launch(_PROBE, ue, None, args, out, (n0, j), route,
                             split)
        return out

    def _plan(self, mode, E, device, route, split, sb=4):
        """(route, split, grid) of a launch on E elements, cached per
        variant, state bytes ``sb``, E and forced route (the device is
        the tables', the operand type the module's): the host cost of a
        launch is most of a small kernel's time, and the bf16 variants
        have their own registers, shared memory and occupancy."""
        key = (mode, E, route, split, sb)
        if key not in self._plans:
            d, k, q1 = self.dim, self.degree, self.q1d
            own_rule = q1 == k + 1 and (d, k) in SUPPORTED
            if not (own_rule or (d, k, q1) in OTHER_POINTS) \
                    or q1 ** d != self.nq:
                raise ValueError(
                    f"CUDA GLS kernel: no variant for dim={d}, degree={k} "
                    f"with {self.nq} quadrature points (compiled: Q1/Q2 in "
                    f"2D/3D with degree+1 points per axis, Q1 with 3)")
            n_sms = pt.sm_count(device)
            r = (route_for(d, k, E, n_sms, route) if own_rule
                 else pt.choose_route(route, False, E, REG_MIN_PER_SM,
                                      n_sms))
            rule = {} if own_rule else {"points": q1}
            if self._ob == 2:
                rule["operand_bytes"] = 2
            n = 1
            if r == pt.REGISTERS:
                op = {"operand_bytes": 2} if self._ob == 2 else {}
                n = split or pt.split_for(
                    E, [(s, config_on_card(d, k, mode, r, s, sb, **op)[0])
                        for s in REG_SPLITS[d]], n_sms, REG_THREADS)
            grid = pt.persistent_grid(
                E, tile_config(d, k, mode, r, n, sb, **rule)["be"],
                config_on_card(d, k, mode, r, n, sb, **rule)[0], n_sms)
            self._plans[key] = (r, n, grid)
        return self._plans[key]

    def _launch(self, mode, ue, due, args, out, probe=(0, 0), route="auto",
                split=None):
        xe, up, fq, h, alpha0, sdt = args
        d, nn, nq, c = self.dim, self.nn, self.nq, self.nc
        E = ue.shape[-1]
        sb, ob = pt.state_bytes(ue), self._ob
        if ob == 2 and sb != 2:
            raise ValueError(f"CUDA GLS kernel with bf16 operands: got "
                             f"{ue.dtype} rows")
        if sb != 4 and ob == 4 and mode not in BF16_MODES:
            raise ValueError("CUDA GLS kernel: bf16 state rows are taken by "
                             "the tangent and the probes only")
        state = [(ue, (nn, c, E)), (xe, (nn, d, E)), (up, (nn, d, E)),
                 (fq, (nq, d, E)), (h, (E,))]
        other = [(out, out.shape), (self.tables, self.tables.shape)]
        if due is not None:
            other.append((due, (nn, c, E)))
        dev = ue.get_device()
        # bf16 operands: every tensor is bf16 at the state rows' pitch
        pitch = (pt.check_rows("GLS", dev, state + other, []) if ob == 2
                 else pt.check_rows("GLS", dev, state, other))
        route, split, grid = self._plan(mode, E, dev, route, split, sb)
        ptrs = [t.data_ptr() for t in (ue, xe, up, fq, h)]
        pitch_bytes = [sb * pitch]
        if due is not None:
            ptrs.append(due.data_ptr())
            pitch_bytes.append(2 * pitch if ob == 2 else 4 * E)
        err = get_build().lib.gls_element_launch(
            d, self.degree, self.q1d, mode, sb, ob, ptrs[0],
            ptrs[5] if due is not None else None, *ptrs[1:5],
            self.tables.data_ptr(), out.data_ptr(), E, pitch, self.nu,
            float(alpha0), float(sdt), *self._flags, probe[0], probe[1],
            route, split, grid, pt.load_path(E, ptrs, pitch_bytes),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"GLS element kernel launch failed: CUDA "
                               f"error {err}")
        cls = GLSElementKernel
        cls.launches += 1
        key = (d, self.degree, self.q1d, E, MODES[mode] + (
            "_bf16op" if ob == 2 else "_bf16" if sb == 2 else ""))
        cls.launches_by_shape[key] = cls.launches_by_shape.get(key, 0) + 1
