"""Sharded GLS Navier-Stokes solve (counterpart of
``softx_2020_200_tpu.parallel.sharded``).

The JAX package runs one SPMD program under ``shard_map`` over a list of
devices.  Here one process drives a list of ``torch.device``s: shard p
lives on ``devices[p]``, and a device may repeat, so several shards can
share one card.  The process loops over the shards in Python:

- the state is a ``ShardVec``: per-shard ``[N_loc, c]`` tensors on the
  Morton partition of ``partition.py`` (owned nodes first, then ghosts,
  then a trash slot that padding elements name);
- ghost ``refresh`` and partial-sum ``combine`` walk the exchange plan
  hop by hop in the JAX package's order: ``index_select`` on the
  sender, ``.to`` the receiver's device, then a write, or a gather, an
  add and a write, there.  A hop carries real slots only (the JAX plan
  pads every hop to one width through the trash slot), so no slot is
  written twice in a hop and no add is an atomic;
- a norm or inner product is a sum of per-shard partials, moved to
  ``devices[0]`` and added in shard order (``shard_sum``), so its value
  does not depend on timing; the SAME ``newton_solve`` and Krylov code
  as one device runs with ``reduce_fn=shard_sum``;
- the residual, the frozen-tau tangent and the node-block probes run
  per shard through the GLS element kernel B1 (``ops/gls_kernel.py``)
  at the shard's padded element count, box meshes included: the sharded
  path never builds the lattice kernel B2, as in the JAX package.  B1
  runs without a bf16 Jacobian state here (``jacobian state precision``
  is not read), as the JAX sharded path builds it.  It reads each
  element's coordinates relative to the element's first node: J is
  the same, and in float32 the cancellation of absolute coordinates in
  J costs a fine mesh's residual an order of magnitude (the MMS box at
  256^2 over 4 shards stalled Newton near 2e-5 with them, in the JAX
  package's 4-way float32 run too; the lattice kernel B2 of the
  one-device path reads a box's translates and has no such error);
- geometric multigrid: the fine level is sharded; the coarse levels are
  whole, on B1, and run once, on their own device, for all shards (the
  JAX package runs that same replicated cycle on every shard; one
  process computes it once).  Restriction is a per-shard partial
  gather-sum added across shards, prolongation a per-shard gather from
  the coarse correction;
- hanging-node rows of an adapted mesh are localized per shard
  (``partition_space`` closes each shard over the masters it needs):
  distribute after the ghost refresh, transpose on the local partial
  residual before the combine;
- per-shard checkpoints: shard p writes its owned rows and their global
  ids to ``<path>.shard{p}.npz``; a run under any shard count reads them
  back through its own layout.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time as _time

import numpy as np
import torch

from ..core.bdf import bdf_coefficients
from ..core.sdirk import sdirk_coefficients
from ..fem.constraints import HangingConstraints, master_slots
from ..ops.batched_kernel import element_size
from ..ops.gls_kernel import GLSElementKernel
from ..ops.linalg import gmres_fixed
from ..ops.multigrid import N_SMOOTH, OMEGA, build_hierarchy, make_vcycle
from ..ops.operators import assemble, build_assembly_map
from ..ops.preconditioners import apply_node_block_state, node_blocks_to_state
from ..solvers.base import new_stats, record_solve
from ..solvers.gls import GLSOperator, StabFlags
from ..solvers.newton import NewtonConfig, newton_solve
from .partition import ShardLayout, partition_space

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


class ShardVec:
    """A vector split over shards: ``parts[p]`` lives on shard p's device.

    The algebra the Newton and Krylov loops need runs part by part
    (``torch._foreach_*``): sums and differences of two vectors, scaling
    by a number or by a 0-d tensor (moved to each part's device), row
    storage for a Krylov basis (``rows``; indexing and slicing act on
    every part), and products with the basis: ``V @ w`` gives the
    per-shard partial inner products, which ``shard_sum`` adds, and
    ``h @ V`` combines the rows with coefficients ``h``.  ``sum()``
    gives the per-shard partial sums.
    """

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = list(parts)

    # ------------------------------------------------------------------
    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        """The first shard's device (where reductions land)."""
        return self.parts[0].device

    @property
    def shape(self) -> tuple:
        """The parts' shapes (``reshape`` takes it back)."""
        return tuple(p.shape for p in self.parts)

    def reshape(self, shape):
        """-1 flattens every part; a tuple of part shapes restores them."""
        if isinstance(shape, int):
            return ShardVec(p.reshape(shape) for p in self.parts)
        return ShardVec(p.reshape(s) for p, s in zip(self.parts, shape))

    def zeros_like(self) -> "ShardVec":
        return ShardVec(torch.zeros_like(p) for p in self.parts)

    def rows(self, k: int, zero: bool = False) -> "ShardVec":
        """Storage for ``k`` vectors shaped as this flat vector."""
        new = torch.zeros if zero else torch.empty
        return ShardVec(new((k,) + p.shape, dtype=p.dtype, device=p.device)
                        for p in self.parts)

    def sum(self) -> "ShardVec":
        return ShardVec(p.sum() for p in self.parts)

    # ------------------------------------------------------------------
    def _scalars(self, s):
        if isinstance(s, torch.Tensor):
            return [s.to(p.device) for p in self.parts]
        return s

    def __add__(self, other):
        if not isinstance(other, ShardVec):
            return NotImplemented
        return ShardVec(torch._foreach_add(self.parts, other.parts))

    def __sub__(self, other):
        if not isinstance(other, ShardVec):
            return NotImplemented
        return ShardVec(torch._foreach_sub(self.parts, other.parts))

    def __neg__(self):
        return ShardVec(torch._foreach_neg(self.parts))

    def __mul__(self, s):
        if isinstance(s, ShardVec):
            return ShardVec(torch._foreach_mul(self.parts, s.parts))
        return ShardVec(torch._foreach_mul(self.parts, self._scalars(s)))

    __rmul__ = __mul__

    def __truediv__(self, s):
        return ShardVec(torch._foreach_div(self.parts, self._scalars(s)))

    def __matmul__(self, other):
        return ShardVec(a @ b for a, b in zip(self.parts, other.parts))

    def __rmatmul__(self, h):
        return ShardVec(h.to(p.device) @ p for p in self.parts)

    def __getitem__(self, index):
        return ShardVec(p[index] for p in self.parts)

    def __setitem__(self, index, value):
        for p, v in zip(self.parts, value.parts):
            p[index] = v


def shard_sum(partials: ShardVec) -> torch.Tensor:
    """The cross-shard sum (``reduce_fn``): the per-shard partials moved
    to the first shard's device and added in shard order."""
    dev = partials.device
    total = partials.parts[0]
    for part in partials.parts[1:]:
        total = total + part.to(dev)
    return total


def local_hanging(layout: ShardLayout, hc) -> list:
    """Per shard, the hanging-node rows of every hanging node present on
    the shard in local slots (the masters are present by the partition's
    closure), as numpy (ids [H_p], masters [H_p, M], weights [H_p, M]),
    or None where the shard has none (or ``hc`` is None or empty)."""
    if hc is None or hc.n == 0:
        return [None] * layout.n_shards
    trash = layout.N_loc - 1
    hids = hc.ids.cpu().numpy().astype(np.int64)
    hmast = hc.masters.cpu().numpy().astype(np.int64)
    hw = hc.weights.cpu().double().numpy()
    out = []
    for p in range(layout.n_shards):
        g2slot = global_to_slot(layout, p)
        sel = np.nonzero(g2slot[hids] != trash)[0]
        if sel.size == 0:
            out.append(None)
            continue
        mast = g2slot[hmast[sel]]
        if (mast == trash).any():
            raise RuntimeError("hanging-node master missing from shard "
                               "closure")
        out.append((g2slot[hids[sel]], mast, hw[sel]))
    return out


def global_to_slot(layout: ShardLayout, p: int) -> np.ndarray:
    """[N_global] int64: shard p's local slot of each global node (the
    trash slot where the node is absent)."""
    trash = layout.N_loc - 1
    out = np.full(layout.n_nodes_global, trash, dtype=np.int64)
    v = layout.l2g[p]
    ok = v >= 0
    out[v[ok]] = np.nonzero(ok)[0]
    return out


def hanging_on(rows, device, dtype) -> HangingConstraints | None:
    """``local_hanging``'s rows of one shard as constraints on
    ``device`` (None stays None)."""
    if rows is None:
        return None
    ids, mast, w = rows
    umasters, slots = master_slots(mast)
    i64 = dict(dtype=torch.int64, device=device)
    return HangingConstraints(
        ids=torch.as_tensor(ids, **i64), masters=torch.as_tensor(mast, **i64),
        weights=torch.as_tensor(w, dtype=dtype, device=device),
        umasters=torch.as_tensor(umasters, **i64),
        slots=torch.as_tensor(slots, **i64))


class Exchanges:
    """A layout's exchange plan on the shards' devices, with the ghost
    ``refresh`` and the partial-sum ``combine`` of ``[N_loc, k]``
    sharded vectors.  ``hops[k]`` lists, for the layout's k-th exchange,
    each (sender p, receiver q, p's owned slots, q's ghost slots) with
    real entries only."""

    def __init__(self, layout: ShardLayout, devices):
        self.hops = []
        P = layout.n_shards
        for ex in layout.exchanges:
            hop = []
            for p in range(P):
                q = p + ex.delta
                if not 0 <= q < P:
                    continue
                n = int(ex.valid[q].sum())
                if n == 0:
                    continue
                hop.append((p, q,
                            torch.as_tensor(ex.send_idx[p, :n].astype(
                                np.int64), device=devices[p]),
                            torch.as_tensor(ex.recv_idx[q, :n].astype(
                                np.int64), device=devices[q])))
            self.hops.append(hop)

    def slots_per_refresh(self) -> int:
        """Ghost slots one refresh writes (all shards, all hops)."""
        return sum(int(s.numel()) for hop in self.hops
                   for _, _, s, _ in hop)

    def refresh(self, u: ShardVec) -> ShardVec:
        """Owner values into the ghost slots (a new vector)."""
        parts = [x.clone() for x in u.parts]
        for hop in self.hops:
            for p, q, send, recv in hop:
                got = parts[p].index_select(0, send).to(parts[q].device)
                parts[q].index_copy_(0, recv, got)
        return ShardVec(parts)

    def combine(self, r: ShardVec) -> ShardVec:
        """Ghost partial sums added into their owners' slots (in place;
        the ghost slots keep their partials)."""
        parts = r.parts
        for hop in self.hops:
            for p, q, send, recv in hop:
                got = parts[q].index_select(0, recv).to(parts[p].device)
                parts[p].index_copy_(0, send,
                                     parts[p].index_select(0, send) + got)
        return r


@dataclasses.dataclass
class Shard:
    """One shard's constants on its device."""
    device: torch.device
    kernel: GLSElementKernel
    en_t: torch.Tensor       # [nn, E] int64 local slots
    xe: torch.Tensor         # [nn, d, E] relative to node 0
    h: torch.Tensor          # [E] element size, as B1 takes it
    valid: torch.Tensor      # [E] 1 for a real element, 0 for padding
    owned: torch.Tensor      # [N_loc, 1] 1 for an owned node
    amap: torch.Tensor       # [N_loc, M] gather-sum assembly map
    mask: torch.Tensor       # [N_loc, c] Dirichlet and hanging rows
    coords: torch.Tensor     # [N_loc, d]
    qpts: torch.Tensor       # [E, nq, d] physical quadrature points
    cfl_h: torch.Tensor      # [E] element size of the CFL number
    hc: HangingConstraints | None
    bc_slots: list           # per function-bc entry: local slots
    slots: torch.Tensor      # local slots that hold a node ...
    gids: torch.Tensor       # ... and that node's global id
    own_slots: torch.Tensor  # owned slots ...
    own_gids: torch.Tensor   # ... and their global ids

    def soa(self, x):
        """Nodal x[N_loc, k] -> element rows [nn, k, E]."""
        return x[self.en_t].transpose(1, 2).contiguous()

    def assemble(self, r):
        """Element rows r[nn, k, E] -> the local partial [N_loc, k]."""
        return assemble(r.permute(2, 0, 1), self.amap)


class ShardedGLSSolver:
    """Steady and transient GLS Newton solves over shards."""

    def __init__(self, space, nu: float, devices, *,
                 n_q1d: int | None = None,
                 stab: StabFlags = StabFlags(),
                 newton: NewtonConfig = NewtonConfig(),
                 dtype: torch.dtype = torch.float32,
                 precond: str = "block_jacobi", source_fn=None,
                 bc_exprs=None, bc_mask=None, mg=None, hc=None,
                 mg_smoother: str = "jacobi", mg_krylov_m: int = 4,
                 mg_cycle: str = "v", strike_parent=None,
                 gmg_strikes: int = 0, stats: dict | None = None,
                 log_newton=None):
        """devices:   one torch.device per shard (repeats allowed)
        precond:   'jacobi' | 'block_jacobi' | 'gmg'
        source_fn: (qpts[..., d], t) -> [..., d] body force
        bc_exprs:  list of (global node ids, [Expression per velocity
                   component]) evaluated at each solve's time
        bc_mask:   global [N, c] bool Dirichlet mask (default: all free)
        mg:        a hierarchy of ``ops/multigrid.py`` (``Level`` list,
                   finest first); levels [1:] become the coarse levels
        hc:        hanging-node constraints of an adapted mesh
        stats:     the counts ``record_solve`` adds to (the engine's)
        log_newton: called with each solve's ``NewtonResult`` (the
                   engine's ``_log_newton``)
        """
        self.devices = [torch.device(d) for d in devices]
        self.n_shards = P = len(self.devices)
        self.hc = hc if (hc is not None and hc.n) else None
        hc_host = None if self.hc is None else self.hc.to("cpu",
                                                          torch.float64)
        self.layout = L = partition_space(space, P, hc=hc_host)
        self.space = space
        self.dim = d = space.dim
        self.nc = c = d + 1
        self.nu = float(nu)
        self.stab = stab
        self.dtype = dtype
        self.source_fn = source_fn
        self.newton_cfg = newton
        self.precond_kind = precond
        self.stats = stats if stats is not None else new_stats()
        self._log_newton = log_newton
        self._gmg_strikes = int(gmg_strikes)
        self._strike_parent = strike_parent
        self._bc_exprs = [exprs for _, exprs in (bc_exprs or [])]

        n_q1d = n_q1d or (space.degree + 1)
        _, wts, B, G, H = space.basis.quadrature(n_q1d)
        kernels = {dev: GLSElementKernel(
            dim=d, degree=space.degree, B=B, G=G, H=H, w=wts, nu=self.nu,
            stab=stab, dtype=dtype, device=dev) for dev in set(self.devices)}
        self._B = {dev: torch.as_tensor(np.array(B), dtype=dtype, device=dev)
                   for dev in set(self.devices)}

        if bc_mask is None:
            bc_mask = np.zeros((space.n_nodes, c), bool)
        mask_g = np.asarray(torch.as_tensor(bc_mask).cpu(), bool).copy()
        if self.hc is not None:
            mask_g[hc_host.ids.numpy()] = True
        masks = L.to_local(mask_g.astype(np.float64)) > 0.5
        coords = L.to_local(space.nodes)
        hanging = local_hanging(L, hc_host)
        # element sizes of the CFL number: the solve's own quadrature
        # (padding elements are reference cells, masked by valid)
        Jh = np.einsum("peni,qnj->peqij", L.xe, np.asarray(G))
        volh = np.einsum("peq,q->pe", np.linalg.det(Jh), np.asarray(wts))
        if d == 2:
            cfl_h = np.sqrt(4.0 * np.abs(volh) / np.pi) / space.degree
        else:
            cfl_h = np.cbrt(6.0 * np.abs(volh) / np.pi) / space.degree
        trash = L.N_loc - 1
        self.shards = []
        for p, dev in enumerate(self.devices):
            fl = dict(dtype=dtype, device=dev)
            i64 = dict(dtype=torch.int64, device=dev)
            g2slot = global_to_slot(L, p)
            bc_slots = []
            for gids, _ in (bc_exprs or []):
                s = g2slot[np.asarray(gids, dtype=np.int64)]
                bc_slots.append(torch.as_tensor(s[s != trash], **i64))
            valid = L.l2g[p] >= 0
            own = L.owned_mask[p] > 0
            amap = build_assembly_map(L.elem_nodes[p], L.N_loc,
                                      exclude_node=trash)
            self.shards.append(Shard(
                device=dev, kernel=kernels[dev],
                en_t=torch.as_tensor(L.elem_nodes[p].T.astype(np.int64),
                                     **i64),
                xe=torch.as_tensor(np.ascontiguousarray(np.transpose(
                    L.xe[p] - L.xe[p][:, :1], (1, 2, 0))), **fl),
                h=torch.as_tensor(element_size(space.basis, space.degree,
                                               L.xe[p]), **fl),
                valid=torch.as_tensor(L.elem_valid[p], **fl),
                owned=torch.as_tensor(L.owned_mask[p][:, None], **fl),
                amap=amap.idx.to(dev),
                mask=torch.as_tensor(masks[p], device=dev),
                coords=torch.as_tensor(coords[p], **fl),
                qpts=torch.as_tensor(np.einsum("qn,end->eqd", B, L.xe[p]),
                                     **fl),
                cfl_h=torch.as_tensor(np.maximum(cfl_h[p], 1e-30), **fl),
                hc=hanging_on(hanging[p], dev, dtype), bc_slots=bc_slots,
                slots=torch.as_tensor(np.nonzero(valid)[0], **i64),
                gids=torch.as_tensor(L.l2g[p][valid], **i64),
                own_slots=torch.as_tensor(np.nonzero(own)[0], **i64),
                own_gids=torch.as_tensor(L.l2g[p][own], **i64)))
        self.exchanges = Exchanges(L, self.devices)

        # ---------------- multigrid (optional) ------------------------
        self._mg = None
        self._gmg_stash = None
        if precond == "gmg" and mg is not None and len(mg) >= 2:
            self._mg = self._wire_gmg(mg, mg_smoother, mg_krylov_m,
                                      mg_cycle)
            self.newton_cfg = dataclasses.replace(self.newton_cfg,
                                                  flexible=True)
        elif precond == "gmg":
            self.precond_kind = "block_jacobi"

    # ------------------------------------------------------------------
    @classmethod
    def from_solver(cls, solver, devices):
        """Wire a sharded solver from a configured single-device
        ``GLSNavierStokesSolver``: same physics, boundary conditions,
        sources, preconditioner family and Newton settings; its counts go
        to the engine's ``stats``.  GMG stagnation strikes carry over
        both ways, so an evicted GMG stays evicted across the re-shard
        after each Kelly cycle."""
        precond = solver.precond_kind
        strikes = solver._gmg_strikes
        if precond == "gmg" and strikes >= 2:
            precond = "block_jacobi"
        mg = None
        if precond == "gmg":
            mg = solver.mg_levels or build_hierarchy(solver)
            if len(mg) < 2:
                precond, mg = "block_jacobi", None
        source_fn = solver._mms_source
        if source_fn is None and solver.source is not None:
            src, dd = solver.source, solver.dim

            def source_fn(q, t):
                return src.spatial(q, t)[..., :dd]
        op = solver.op
        ls = solver.prm.linear_solver
        return cls(
            solver.space, op.nu, devices,
            n_q1d=int(round(op.n_q ** (1.0 / op.dim))), stab=op.stab,
            newton=solver.newton_cfg, dtype=solver.dtype,
            precond=precond, source_fn=source_fn,
            bc_exprs=solver.bh.function_entries, bc_mask=solver.bh.mask,
            mg=mg, hc=solver.hc if solver.hc.n else None,
            mg_smoother=ls.resolved_mg_smoother(
                solver.control.is_steady(), degree=solver.space.degree),
            mg_krylov_m=ls.mg_krylov_vectors,
            mg_cycle=ls.resolved_mg_cycle(), strike_parent=solver,
            gmg_strikes=strikes, stats=solver.stats,
            log_newton=solver._log_newton)

    # ------------------------------------------------------------------
    def _wire_gmg(self, mg, smoother, krylov_m, cycle) -> dict:
        """The coarse levels on B1 with the compute-dtype state, their
        cycle, and per shard the level-0 <-> level-1 transfers: the
        prolongation's masters and weights at the shard's local slots
        (with their restriction map) and the Newton state's injection or
        interpolation, each fine node counted on its owner shard."""
        coarse = [self._on_b1(lvl) for lvl in mg[1:]]
        lvl1 = coarse[0]
        Nc = lvl1.mask.shape[0]
        L = self.layout
        trash = L.N_loc - 1
        masters = lvl1.masters.cpu().numpy()                # [Nf, nn_c]
        weights = lvl1.weights.cpu().double().numpy()
        if lvl1.inject is not None:
            im = lvl1.inject.cpu().numpy()[:, None]           # [Nc, 1]
            iw = np.ones(im.shape)
        else:
            im = lvl1.inj_masters.cpu().numpy()               # [Nc, K]
            iw = lvl1.inj_weights.cpu().double().numpy()
        owner = np.full(self.space.n_nodes, -1, np.int64)
        for p in range(self.n_shards):
            owner[L.l2g[p][L.owned_mask[p] > 0]] = p
        per_shard = []
        for p, sh in enumerate(self.shards):
            fl = dict(dtype=self.dtype, device=sh.device)
            i64 = dict(dtype=torch.int64, device=sh.device)
            valid = L.l2g[p] >= 0
            ml = np.zeros((L.N_loc, masters.shape[1]), np.int64)
            wl = np.zeros((L.N_loc, masters.shape[1]))
            ml[valid] = masters[L.l2g[p][valid]]
            wl[valid] = weights[L.l2g[p][valid]]
            mine = owner[im] == p
            g2slot = global_to_slot(L, p)
            per_shard.append(dict(
                masters=torch.as_tensor(ml, **i64),
                weights=torch.as_tensor(wl, **fl),
                restrict_idx=build_assembly_map(ml, Nc).idx.to(sh.device),
                state_slots=torch.as_tensor(
                    np.where(mine, g2slot[im], trash), **i64),
                state_weights=torch.as_tensor(iw * mine, **fl)))
        return dict(level1=lvl1, per_shard=per_shard,
                    device=lvl1.mask.device, smoother=smoother,
                    krylov_m=krylov_m,
                    cycle=make_vcycle(coarse, smoother=smoother,
                                      krylov_m=krylov_m, cycle=cycle,
                                      level_offset=1))

    @staticmethod
    def _on_b1(level):
        """A coarse level whose operator runs B1 with the compute-dtype
        state (the lattice and the bf16 state rebuilt away)."""
        op = level.op
        if op.layout is None and op.state_dtype is None:
            return level
        b1 = GLSOperator(op.space, op.nu,
                         n_q1d=int(round(op.n_q ** (1.0 / op.dim))),
                         stab=op.stab, dtype=op.dtype, device=op.device,
                         lattice=False)
        return dataclasses.replace(level, op=b1)

    # ------------------------------------------------------------------
    # layout conversions
    # ------------------------------------------------------------------
    def to_local(self, u_global) -> ShardVec:
        """Global [N, k] (tensor or array) -> sharded [N_loc, k], ghosts
        filled too."""
        if not isinstance(u_global, torch.Tensor):
            u_global = np.array(u_global)
        u = torch.as_tensor(u_global, dtype=self.dtype,
                            device=self.devices[0])
        parts = []
        for sh in self.shards:
            out = torch.zeros((self.layout.N_loc,) + u.shape[1:],
                              dtype=self.dtype, device=sh.device)
            out[sh.slots] = u[sh.gids.to(u.device)].to(sh.device)
            parts.append(out)
        return ShardVec(parts)

    def to_global(self, v: ShardVec) -> torch.Tensor:
        """Sharded [N_loc, k] -> global [N, k] on the first shard's
        device, from the owned rows."""
        dev = self.devices[0]
        out = torch.zeros((self.layout.n_nodes_global,)
                          + v.parts[0].shape[1:], dtype=v.dtype, device=dev)
        for sh, x in zip(self.shards, v.parts):
            out[sh.own_gids.to(dev)] = x[sh.own_slots].to(dev)
        return out

    def from_stack(self, stack: np.ndarray) -> ShardVec:
        """[P, N_loc, k] array -> sharded vector."""
        return ShardVec(torch.as_tensor(stack[p], dtype=self.dtype,
                                        device=sh.device)
                        for p, sh in enumerate(self.shards))

    # ------------------------------------------------------------------
    # shard-local pieces
    # ------------------------------------------------------------------
    def refresh(self, u: ShardVec) -> ShardVec:
        return self.exchanges.refresh(u)

    def _fresh(self, u: ShardVec) -> ShardVec:
        """Owner-consistent ghosts, then hanging values from masters."""
        u = self.refresh(u)
        return ShardVec(x if sh.hc is None else sh.hc.distribute(x)
                        for sh, x in zip(self.shards, u.parts))

    def _owned(self, v: ShardVec) -> ShardVec:
        return ShardVec(x * sh.owned for sh, x in zip(self.shards, v.parts))

    @staticmethod
    def _unmasked(v: ShardVec, masks) -> ShardVec:
        return ShardVec(x.masked_fill(m, 0.0) for x, m in zip(v.parts, masks))

    def _finish_rows(self, r_el: list, masks) -> ShardVec:
        """Per-shard element rows -> the constrained residual rows:
        assembly and the hanging transpose per shard, the cross-shard
        combine, owned rows only, zero at the masked rows."""
        parts = []
        for sh, r in zip(self.shards, r_el):
            R = sh.assemble(r * sh.valid)
            parts.append(R if sh.hc is None else sh.hc.distribute_transpose(R))
        R = self.exchanges.combine(ShardVec(parts))
        return self._unmasked(self._owned(R), masks)

    def _problem(self, combo: ShardVec, t, alpha0, sdt) -> dict:
        """The constants of one nonlinear solve: masks, the refreshed
        history combination in element rows, the body force at the
        shards' quadrature points, and the Dirichlet values at t."""
        masks = [sh.mask for sh in self.shards]
        cr = self.refresh(combo)
        up, fq, vals = [], [], []
        d = self.dim
        for p, sh in enumerate(self.shards):
            up.append(sh.soa(cr.parts[p]))
            if self.source_fn is not None:
                f = self.source_fn(sh.qpts, t).to(self.dtype)
            else:
                f = torch.zeros_like(sh.qpts)
            fq.append(f[..., :d].permute(1, 2, 0).contiguous())
            v = torch.zeros((self.layout.N_loc, self.nc), dtype=self.dtype,
                            device=sh.device)
            for slots, exprs in zip(sh.bc_slots, self._bc_exprs):
                pts = sh.coords[slots]
                for ci, e in enumerate(exprs):
                    v[slots, ci] = e.spatial(pts, t).to(self.dtype)
            vals.append(v)
        return dict(masks=masks, combo=combo, up=up, fq=fq, vals=vals,
                    alpha0=float(alpha0), sdt=float(sdt))

    def _constrain(self, u: ShardVec, pb: dict) -> ShardVec:
        return ShardVec(torch.where(m, v, x) for x, m, v in
                        zip(u.parts, pb["masks"], pb["vals"]))

    def residual(self, u: ShardVec, pb: dict) -> ShardVec:
        """The constrained sharded residual R(u)."""
        u = self._fresh(u)
        a0, sdt = pb["alpha0"], pb["sdt"]
        r_el = [sh.kernel.residual(sh.soa(x), sh.xe, up, fq, sh.h, a0, sdt)
                for sh, x, up, fq in zip(self.shards, u.parts, pb["up"],
                                         pb["fq"])]
        return self._finish_rows(r_el, pb["masks"])

    def jacobian(self, u: ShardVec, pb: dict):
        """v -> J(u) v, the element state taken once here: B1's frozen-tau
        tangent on CUDA, exact tau (unless frozen) on the CPU, as the
        one-device operator."""
        ue = [sh.soa(x) for sh, x in zip(self.shards, self._fresh(u).parts)]
        a0, sdt = pb["alpha0"], pb["sdt"]

        def matvec(v):
            dv = self._fresh(v)
            dr = [sh.kernel.tangent(e, sh.soa(x), sh.xe, up, fq, sh.h, a0,
                                    sdt)
                  for sh, e, x, up, fq in zip(self.shards, ue, dv.parts,
                                              pb["up"], pb["fq"])]
            return self._finish_rows(dr, pb["masks"])

        return matvec

    def node_block_inverses(self, u: ShardVec, pb: dict) -> list:
        """Per shard, the inverses of the assembled node-diagonal
        (d+1)x(d+1) Jacobian blocks [N_loc, c, c] from B1's probes
        (identity on masked components; ghost rows identity)."""
        u = self._fresh(u)
        c = self.nc
        a0, sdt = pb["alpha0"], pb["sdt"]
        parts = []
        for sh, x, up, fq, m in zip(self.shards, u.parts, pb["up"],
                                    pb["fq"], pb["masks"]):
            blocks = sh.kernel.node_blocks(sh.soa(x), sh.xe, up, fq, sh.h,
                                           a0, sdt) * sh.valid
            keep = sh.soa(1.0 - m.to(self.dtype))                # [nn, c, E]
            keep2 = keep[:, :, None, :] * keep[:, None, :, :]
            parts.append(sh.assemble(blocks * keep2.reshape(blocks.shape)))
        blocks = self.exchanges.combine(ShardVec(parts))
        eye = {dev: torch.eye(c, dtype=self.dtype, device=dev)
               for dev in set(self.devices)}
        # ghost rows (partial sums; their output is masked) invert as
        # identity: a zero block's determinant is no test in float32
        return [node_blocks_to_state("block_jacobi", torch.where(
            sh.owned[:, :, None] > 0.5, b.reshape(-1, c, c), eye[sh.device]),
            m) for sh, b, m in zip(self.shards, blocks.parts, pb["masks"])]

    # ------------------------------------------------------------------
    # preconditioners
    # ------------------------------------------------------------------
    def _precond_builder(self, pb: dict):
        """u -> (w -> M^-1 w), deciding at each Newton iterate (a GMG that
        stalls is swapped for block-Jacobi within a solve)."""

        def builder(u):
            if self._mg is not None:
                return self._gmg(u, pb)
            binv = self.node_block_inverses(u, pb)
            if self.precond_kind == "jacobi":
                # the JAX sharded path's point Jacobi: the diagonal of
                # the block inverses
                binv = [torch.diagonal(b, dim1=1, dim2=2) for b in binv]
            return lambda w: self._owned(ShardVec(
                apply_node_block_state(b, x) for b, x in zip(binv, w.parts)))

        return builder

    def _to_coarse(self, a: ShardVec) -> torch.Tensor:
        """The first coarse level's nodal state from the owned rows of
        ``a`` (injection or interpolation), on the coarse device."""
        mg = self._mg
        part = ShardVec(
            torch.einsum("nk,nkc->nc", t["state_weights"],
                         x[t["state_slots"]])
            for t, x in zip(mg["per_shard"], self._owned(a).parts))
        return shard_sum(part).to(mg["device"])

    def _gmg(self, u: ShardVec, pb: dict):
        """The multigrid preconditioner at the Newton iterate u: the fine
        level sharded (node-block smoother from B1's probes, the sharded
        tangent), the coarse cycle whole."""
        mg = self._mg
        masks = pb["masks"]
        binv = self.node_block_inverses(u, pb)
        jv = self.jacobian(u, pb)
        lvl1 = mg["level1"]
        d = self.dim

        def smooth(r):
            return self._owned(ShardVec(
                apply_node_block_state(b, x) for b, x in zip(binv, r.parts)))

        def matvec(v):
            kept = ShardVec(x.masked_fill(~m, 0.0)
                            for x, m in zip(v.parts, masks))
            return jv(self._unmasked(v, masks)) + kept

        def kry_smooth(r, z0):
            shape = r.shape
            return gmres_fixed(
                lambda x: matvec(x.reshape(shape)).reshape(-1),
                r.reshape(-1), x0=None if z0 is None else z0.reshape(-1),
                precond=lambda x: smooth(x.reshape(shape)).reshape(-1),
                m=mg["krylov_m"], reduce_fn=shard_sum).reshape(shape)

        op1 = lvl1.op
        fqc = torch.zeros((op1.space.n_elements, op1.n_q, d),
                          dtype=self.dtype, device=mg["device"])
        coarse = mg["cycle"](self._to_coarse(u), self._to_coarse(
            pb["combo"]), fqc, pb["alpha0"], pb["sdt"], lvl1.mask)
        krylov = mg["smoother"] == "krylov"

        def apply(r):
            z = kry_smooth(r, None) if krylov else OMEGA * smooth(r)
            for _ in range(N_SMOOTH - 1 if not krylov else 0):
                z = z + OMEGA * smooth(r - matvec(z))
            res = self._owned(r - matvec(z))
            rc = shard_sum(ShardVec(
                assemble(t["weights"][:, :, None] * x[:, None, :],
                         t["restrict_idx"])
                for t, x in zip(mg["per_shard"], res.parts)))
            rc = lvl1.hc_transpose(rc.to(mg["device"]))
            zc = lvl1.hc_distribute(coarse(rc.masked_fill(lvl1.mask, 0.0)))
            zf = ShardVec(
                torch.einsum("fm,fmc->fc", t["weights"],
                             zc.to(x.device)[t["masters"]])
                for t, x in zip(mg["per_shard"], r.parts))
            z = z + self._owned(self._unmasked(zf, masks))
            if krylov:
                return kry_smooth(r, z)
            return z + OMEGA * smooth(r - matvec(z))

        return apply

    def _disable_gmg(self) -> bool:
        """Swap a stalling GMG for block-Jacobi (the linear solve ran out
        of its budget above its tolerance), as the one-device engine's
        ``_gmg_fallback``; the Newton iteration is then retried.  The
        strike goes to the engine this solver was wired from too."""
        if self._mg is None:
            return False
        print("linear solver: GMG stagnated (linear budget exhausted); "
              "falling back to block-Jacobi preconditioning")
        self._gmg_strikes += 1
        if self._strike_parent is not None:
            self._strike_parent._gmg_strikes = max(
                self._strike_parent._gmg_strikes, self._gmg_strikes)
        self._gmg_stash = (self._mg, self.precond_kind)
        self._mg = None
        self.precond_kind = "block_jacobi"
        return True

    def _gmg_probation(self) -> None:
        """Restore a fallen-back GMG for the next nonlinear solve, while it
        has fewer than two strikes."""
        if self._gmg_stash is not None and self._gmg_strikes < 2:
            self._mg, self.precond_kind = self._gmg_stash
            self._gmg_stash = None

    # ------------------------------------------------------------------
    # solves
    # ------------------------------------------------------------------
    def solve_local(self, u: ShardVec, combo: ShardVec, t=0.0, alpha0=0.0,
                    sdt=0.0):
        """One nonlinear solve on sharded state; returns the
        ``NewtonResult`` whose ``u`` is sharded, with owner-consistent
        ghosts and hanging values."""
        self._gmg_probation()
        t0 = _time.perf_counter()
        pb = self._problem(combo, t, alpha0, sdt)
        u = self._constrain(u, pb)
        res = newton_solve(lambda v: self.residual(v, pb),
                           lambda v: self.jacobian(v, pb), u,
                           precond_builder=self._precond_builder(pb),
                           config=self.newton_cfg,
                           on_linear_stall=self._disable_gmg,
                           reduce_fn=shard_sum)
        res = res._replace(u=self._fresh(res.u))
        record_solve(self.stats, res, _time.perf_counter() - t0,
                     self.newton_cfg.tolerance)
        if self._log_newton is not None:
            self._log_newton(res)
        return res

    def _combo(self, prevs, alphas) -> ShardVec:
        d = self.dim
        combo = float(alphas[1]) * prevs[0][:, :d]
        for i in range(2, len(alphas)):
            combo = combo + float(alphas[i]) * prevs[i - 1][:, :d]
        return combo

    def bdf_step(self, u: ShardVec, prevs: list, t: float, dts, order: int):
        """One variable-dt BDF step; ``prevs`` the last three solutions,
        newest first.  Returns (u_new, prevs_new, NewtonResult)."""
        eff = max(1, min(int(order), 3))
        a = bdf_coefficients(eff, list(dts)[:eff])
        res = self.solve_local(u, self._combo(prevs, a), t=t,
                               alpha0=float(a[0]), sdt=1.0 / dts[0])
        return res.u, [res.u, prevs[0], prevs[1]], res

    def sdirk_step(self, u: ShardVec, t_old: float, dt: float, order: int):
        """One SDIRK22/SDIRK33 step, the one-device engine's stage
        sequence.  Returns (u_new, the last stage's NewtonResult)."""
        table = sdirk_coefficients(order, dt)
        A, c = table[:, :order], table[:, order]
        d = self.dim
        u_n = u
        ks = []
        res = None
        for s_i in range(order):
            gamma = float(A[s_i, s_i])
            alpha0 = 1.0 / (dt * gamma)
            combo = (-alpha0) * u_n[:, :d]
            for j in range(s_i):
                combo = combo - (float(A[s_i, j]) / gamma) * ks[j]
            res = self.solve_local(u, combo, t=t_old + float(c[s_i]) * dt,
                                   alpha0=alpha0, sdt=1.0 / dt)
            u = res.u
            ks.append(alpha0 * u[:, :d] + combo)
        return u, res

    def cfl(self, u: ShardVec, dt: float) -> float:
        """The CFL number max |u_q| dt / h over the shards' elements (one
        number read back)."""
        d = self.dim
        vals = []
        for sh, x in zip(self.shards, u.parts):
            uq = torch.einsum("qn,ned->qed", self._B[sh.device],
                              x[sh.en_t, :d])
            speed = torch.linalg.vector_norm(uq, dim=-1)          # [q, E]
            vals.append(torch.max(speed / sh.cfl_h * sh.valid).reshape(1)
                        .to(self.devices[0]))
        return float(torch.cat(vals).max()) * dt

    # ------------------------------------------------------------------
    # global-array API (tests, diagnostics)
    # ------------------------------------------------------------------
    def _zero_combo(self) -> ShardVec:
        return ShardVec(torch.zeros((self.layout.N_loc, self.dim),
                                    dtype=self.dtype, device=sh.device)
                        for sh in self.shards)

    def solve(self, u0_global, uprev_combo_global=None, alpha0=0.0, sdt=0.0,
              t=0.0):
        """One nonlinear solve from global arrays.  Returns (u [N, c] on
        the first shard's device, NewtonResult)."""
        combo = (self._zero_combo() if uprev_combo_global is None
                 else self.to_local(uprev_combo_global))
        res = self.solve_local(self.to_local(u0_global), combo, t, alpha0,
                               sdt)
        return self.to_global(res.u), res

    def residual_global(self, u_global, uprev_combo_global=None, t=0.0,
                        alpha0=0.0, sdt=0.0) -> torch.Tensor:
        """The constrained sharded residual at u (Dirichlet values
        imposed first), gathered to a global [N, c]."""
        combo = (self._zero_combo() if uprev_combo_global is None
                 else self.to_local(uprev_combo_global))
        pb = self._problem(combo, t, alpha0, sdt)
        u = self._constrain(self.to_local(u_global), pb)
        return self.to_global(self.residual(u, pb))

    def run_transient(self, u0: ShardVec, dt: float, n_steps: int,
                      order: int = 2, t0: float = 0.0, history=None,
                      on_step=None, startup_scaling: float = 0.0):
        """Fixed-dt BDF time loop on sharded state, as the JAX package's:
        with ``startup_scaling`` in (0, 1) the first ``order - 1`` steps
        are sub-stepped at lower order (sizes (s dt, (1-s) dt)); else the
        order ramps 1 -> ``order`` unless ``history`` (three sharded
        solutions, newest first) seeds it.  ``on_step(k, t, u, res)``
        runs after every step.  Returns the final state."""
        u = u0
        if history is not None:
            prevs, have, dt_hist = list(history), order, [dt] * 3
        else:
            prevs, have, dt_hist = [u0, u0, u0], 0, []
        startup_left = (order - 1 if (history is None
                                      and 0.0 < startup_scaling < 1.0
                                      and order >= 2) else 0)
        for k in range(n_steps):
            t = t0 + (k + 1) * dt
            if startup_left > 0:
                kk = order - startup_left
                dt_a = startup_scaling * dt
                dt_b = dt - dt_a
                u, prevs, res = self.bdf_step(
                    u, prevs, t - dt_b, [dt_a] + dt_hist,
                    min(kk, 1 + len(dt_hist)))
                u, prevs, res = self.bdf_step(
                    u, prevs, t, [dt_b, dt_a] + dt_hist,
                    min(kk + 1, 2 + len(dt_hist)))
                have += 2
                dt_hist = ([dt_b, dt_a] + dt_hist)[:3]
                startup_left -= 1
            else:
                u, prevs, res = self.bdf_step(u, prevs, t, [dt] + dt_hist,
                                              min(order, have + 1))
                have += 1
                dt_hist = ([dt] + dt_hist)[:3]
            if on_step is not None:
                on_step(k, t, u, res)
        return u

    # ------------------------------------------------------------------
    # per-shard checkpoint
    # ------------------------------------------------------------------
    def write_checkpoint_shards(self, path: str, u: ShardVec,
                                prevs: list) -> None:
        """Shard p writes only its owned rows and their global ids to
        ``<path>.shard{p}.npz`` (keys gids, u, prev; through a temporary
        file and ``os.replace``), one shard at a time; no global state
        is formed.  Files of an earlier run with more shards go.  The
        engine writes the manifest (forest, control, pvd) itself."""
        for p, sh in enumerate(self.shards):
            own = sh.own_slots
            f = f"{path}.shard{p}.npz"
            np.savez(f + ".tmp", gids=sh.own_gids.cpu().numpy(),
                     u=u.parts[p][own].cpu().numpy(),
                     prev=np.stack([v.parts[p][own].cpu().numpy()
                                    for v in prevs]))
            os.replace(f + ".tmp.npz", f)
        for f in glob.glob(path + ".shard*.npz"):
            try:
                p = int(f.rsplit(".shard", 1)[1].split(".")[0])
            except ValueError:
                continue
            if p >= self.n_shards:
                os.remove(f)

    @staticmethod
    def read_checkpoint_shards(path: str, layout: ShardLayout, dtype):
        """Local stacks (u [P, N_loc, c], prevs [n_prev, P, N_loc, c],
        numpy in ``dtype``) from per-shard files written under any shard
        count: every local row, owned and ghost, is filled from whichever
        old shard owned it, one old file at a time."""
        dtype = _NP_DTYPES.get(dtype, dtype)
        files = sorted(glob.glob(path + ".shard*.npz"))
        if not files:
            raise FileNotFoundError(path + ".shard*.npz")
        P, N_loc = layout.n_shards, layout.N_loc
        with np.load(files[0], allow_pickle=False) as d0:
            c = d0["u"].shape[-1]
            n_prev = d0["prev"].shape[0]
        u = np.zeros((P, N_loc, c), dtype)
        prevs = np.zeros((n_prev, P, N_loc, c), dtype)
        valid = [layout.l2g[q] >= 0 for q in range(P)]
        for f in files:
            with np.load(f, allow_pickle=False) as d:
                gids, u_p, prev_p = d["gids"], d["u"], d["prev"]
            order = np.argsort(gids)
            gs = gids[order]
            for q in range(P):
                rows = layout.l2g[q][valid[q]]
                pos = np.searchsorted(gs, rows)
                posc = np.minimum(pos, len(gs) - 1)
                hit = (pos < len(gs)) & (gs[posc] == rows)
                if not hit.any():
                    continue
                li = np.nonzero(valid[q])[0][hit]
                src = order[posc[hit]]
                u[q, li] = u_p[src]
                for i in range(n_prev):
                    prevs[i, q, li] = prev_p[i][src]
        return u, prevs

    def shard_report(self) -> tuple:
        """Per shard (owned nodes, ghost nodes), and the bytes one
        refresh of the [N_loc, c] state moves between shards."""
        L = self.layout
        rows = []
        for p in range(self.n_shards):
            own = int((L.owned_mask[p] > 0).sum())
            rows.append((own, int((L.l2g[p] >= 0).sum()) - own))
        nbytes = (self.exchanges.slots_per_refresh() * self.nc
                  * torch.empty((), dtype=self.dtype).element_size())
        return rows, nbytes
