"""Sharded grad-div (Taylor-Hood) Navier-Stokes solve (counterpart of
``softx_2020_200_tpu.parallel.sharded_gd``).

The GD engine is mixed: velocity Q(k+1) and pressure Qk live in two
spaces over the same elements.  Both are partitioned with the SAME
Morton element ranges (every element wholly on one shard in both
spaces), each with its own ghost layer and exchange plan
(``sharded.Exchanges``).  A shard's state is one flat tensor, its
velocity rows ``[Nv_loc * d]`` then its pressure ``[Np_loc]``:

    residual = the plain GD element residual (``solvers/gd.py``'s
               ``gd_soa_residual``, which the JAX sharded path runs too,
               never the lattice kernel B3) per shard on element-local
               coordinates (as ``sharded.py`` feeds B1), gather-sum
               assembly, hanging transposes, the combine per space
    tangent  = ``torch.func.jvp`` of that residual per shard (exact)
    Newton   = ``solvers/newton.py`` with ``reduce_fn=shard_sum``
    precond  = the block-Schur shape of the JAX sharded path: velocity
               node-block inverses (closed form,
               ``ops/gd_multigrid.element_velocity_blocks``) and the
               grad-div Schur approximation -(nu + gamma) / lumped
               pressure mass, both assembled per shard and combined

The engine keeps its orchestration (time loop, SDIRK, Kelly, restart,
post-processing) on global state and hands each nonlinear solve to
``ShardedGDSolver.solve`` through its ``_sharded_hook``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.batched_kernel import _det_inv_soa
from ..ops.gd_multigrid import element_velocity_blocks
from ..ops.operators import assemble, build_assembly_map
from ..ops.preconditioners import _invert_blocks
from ..solvers.gd import gd_soa_residual
from ..solvers.newton import newton_solve
from .partition import morton_order, partition_space
from .sharded import (Exchanges, ShardVec, hanging_on, local_hanging,
                      shard_sum)


@dataclasses.dataclass
class GDShard:
    """One shard's constants on its device (v: velocity space, p:
    pressure space)."""
    device: torch.device
    tables: tuple            # (Bv, Gv, Bp, w) on the device
    cv_t: torch.Tensor       # [nnv, E] int64
    cp_t: torch.Tensor       # [nnp, E] int64
    valid: torch.Tensor      # [E]
    xe: torch.Tensor         # [nnv, d, E] relative to node 0
    qpts: torch.Tensor       # [E, q, d]
    amap_v: torch.Tensor
    amap_p: torch.Tensor
    owned_v: torch.Tensor    # [Nv_loc, 1]
    owned_p: torch.Tensor    # [Np_loc, 1]
    hc_v: object
    hc_p: object
    slots_v: torch.Tensor    # local slots holding a node, global ids,
    gids_v: torch.Tensor     # owned slots and their ids (per space)
    own_slots_v: torch.Tensor
    own_gids_v: torch.Tensor
    slots_p: torch.Tensor
    gids_p: torch.Tensor
    own_slots_p: torch.Tensor
    own_gids_p: torch.Tensor


def _host(hc):
    return None if hc.n == 0 else hc.to("cpu", torch.float64)


class ShardedGDSolver:
    """The GD engine's nonlinear solve over shards."""

    def __init__(self, solver, devices):
        op = self.op = solver.op
        self.solver = solver
        self.dim = d = op.dim
        self.devices = [torch.device(x) for x in devices]
        self.n_shards = P = len(self.devices)
        self.dtype = op.dtype
        self.newton_cfg = solver.newton_cfg
        hc_v, hc_p = _host(solver.hc_v), _host(solver.hc_p)
        order = morton_order(op.space_v.element_coords().mean(axis=1))
        self.Lv = Lv = partition_space(op.space_v, P, elem_order=order,
                                       hc=hc_v)
        self.Lp = Lp = partition_space(op.space_p, P, elem_order=order,
                                       hc=hc_p)
        if (Lv.E_loc != Lp.E_loc
                or not np.array_equal(Lv.elem_valid, Lp.elem_valid)):
            raise RuntimeError("velocity and pressure partitions differ")
        self.ex_v = Exchanges(Lv, self.devices)
        self.ex_p = Exchanges(Lp, self.devices)
        hang_v, hang_p = local_hanging(Lv, hc_v), local_hanging(Lp, hc_p)
        Bv = op.Bv.cpu().numpy()
        tables = {dev: tuple(t.to(dev) for t in (op.Bv, op.Gv, op.Bp, op.w))
                  for dev in set(self.devices)}
        self.shards = []
        for p, dev in enumerate(self.devices):
            fl = dict(dtype=self.dtype, device=dev)
            i64 = dict(dtype=torch.int64, device=dev)

            def ids(a):
                return torch.as_tensor(np.asarray(a, np.int64), **i64)

            def amap(L):
                return build_assembly_map(L.elem_nodes[p], L.N_loc,
                                          exclude_node=L.N_loc - 1).idx.to(
                                              dev)

            vv, vp = Lv.l2g[p] >= 0, Lp.l2g[p] >= 0
            ov, opp = Lv.owned_mask[p] > 0, Lp.owned_mask[p] > 0
            self.shards.append(GDShard(
                device=dev, tables=tables[dev],
                cv_t=ids(Lv.elem_nodes[p].T), cp_t=ids(Lp.elem_nodes[p].T),
                valid=torch.as_tensor(Lv.elem_valid[p], **fl),
                xe=torch.as_tensor(np.ascontiguousarray(np.transpose(
                    Lv.xe[p] - Lv.xe[p][:, :1], (1, 2, 0))), **fl),
                qpts=torch.as_tensor(np.einsum("qn,end->eqd", Bv, Lv.xe[p]),
                                     **fl),
                amap_v=amap(Lv), amap_p=amap(Lp),
                owned_v=torch.as_tensor(Lv.owned_mask[p][:, None], **fl),
                owned_p=torch.as_tensor(Lp.owned_mask[p][:, None], **fl),
                hc_v=hanging_on(hang_v[p], dev, self.dtype),
                hc_p=hanging_on(hang_p[p], dev, self.dtype),
                slots_v=ids(np.nonzero(vv)[0]), gids_v=ids(Lv.l2g[p][vv]),
                own_slots_v=ids(np.nonzero(ov)[0]),
                own_gids_v=ids(Lv.l2g[p][ov]),
                slots_p=ids(np.nonzero(vp)[0]), gids_p=ids(Lp.l2g[p][vp]),
                own_slots_p=ids(np.nonzero(opp)[0]),
                own_gids_p=ids(Lp.l2g[p][opp])))
        self._mp = self._lumped_pressure_mass()

    @classmethod
    def from_solver(cls, solver, devices):
        return cls(solver, devices)

    def shard_report(self) -> tuple:
        """Per shard (owned, ghost) nodes of the velocity and pressure
        spaces, and the bytes one refresh of the mixed state moves
        between shards."""
        rows = []
        for p in range(self.n_shards):
            row = []
            for L in (self.Lv, self.Lp):
                own = int((L.owned_mask[p] > 0).sum())
                row += [own, int((L.l2g[p] >= 0).sum()) - own]
            rows.append(tuple(row))
        nbytes = ((self.ex_v.slots_per_refresh() * self.dim
                   + self.ex_p.slots_per_refresh())
                  * torch.empty((), dtype=self.dtype).element_size())
        return rows, nbytes

    # ------------------------------------------------------------------
    # layout conversions
    # ------------------------------------------------------------------
    def to_local(self, x_global) -> ShardVec:
        """Flat global mixed state [Nv*d + Np] -> sharded flat states."""
        op, d = self.op, self.dim
        x = torch.as_tensor(x_global, dtype=self.dtype,
                            device=self.devices[0])
        v = x[:op.Nv * d].reshape(op.Nv, d)
        pr = x[op.Nv * d:]
        parts = []
        for sh in self.shards:
            lv = torch.zeros((self.Lv.N_loc, d), dtype=self.dtype,
                             device=sh.device)
            lp = torch.zeros(self.Lp.N_loc, dtype=self.dtype,
                             device=sh.device)
            lv[sh.slots_v] = v[sh.gids_v.to(v.device)].to(sh.device)
            lp[sh.slots_p] = pr[sh.gids_p.to(pr.device)].to(sh.device)
            parts.append(torch.cat([lv.reshape(-1), lp]))
        return ShardVec(parts)

    def to_global(self, x: ShardVec) -> torch.Tensor:
        """Sharded flat states -> the flat global state on the first
        shard's device, from the owned rows."""
        op, d = self.op, self.dim
        dev = self.devices[0]
        v = torch.zeros((op.Nv, d), dtype=x.dtype, device=dev)
        pr = torch.zeros(op.Np, dtype=x.dtype, device=dev)
        for sh, xp in zip(self.shards, x.parts):
            lv, lp = self._split(xp)
            v[sh.own_gids_v.to(dev)] = lv[sh.own_slots_v].to(dev)
            pr[sh.own_gids_p.to(dev)] = lp[sh.own_slots_p, 0].to(dev)
        return torch.cat([v.reshape(-1), pr])

    def _velocity_local(self, v_global) -> ShardVec:
        """Global nodal velocity [Nv, d] -> sharded [Nv_loc, d]."""
        v = torch.as_tensor(v_global, dtype=self.dtype,
                            device=self.devices[0])
        parts = []
        for sh in self.shards:
            out = torch.zeros((self.Lv.N_loc, self.dim), dtype=self.dtype,
                              device=sh.device)
            out[sh.slots_v] = v[sh.gids_v.to(v.device)].to(sh.device)
            parts.append(out)
        return ShardVec(parts)

    # ------------------------------------------------------------------
    # shard-local pieces
    # ------------------------------------------------------------------
    def _split(self, xp):
        nv = self.Lv.N_loc * self.dim
        return xp[:nv].reshape(self.Lv.N_loc, self.dim), xp[nv:, None]

    def _fresh(self, x: ShardVec):
        """(velocity [Nv_loc, d], pressure [Np_loc, 1]) per shard with
        owner-consistent ghosts and hanging values from masters."""
        split = [self._split(xp) for xp in x.parts]
        v = self.ex_v.refresh(ShardVec(s[0] for s in split))
        pr = self.ex_p.refresh(ShardVec(s[1] for s in split))
        out = []
        for sh, lv, lp in zip(self.shards, v.parts, pr.parts):
            if sh.hc_v is not None:
                lv = sh.hc_v.distribute(lv)
            if sh.hc_p is not None:
                lp = sh.hc_p.distribute(lp)
            out.append((lv, lp))
        return out

    def _element_state(self, sh, lv, lp):
        return lv[sh.cv_t].transpose(1, 2), lp[sh.cp_t, 0]

    def _finish(self, rows, mask) -> ShardVec:
        """Per-shard element rows (Rv [nnv, d, E], Rp [nnp, E]) -> the
        masked, combined, owned-row residual per shard."""
        rv, rp = [], []
        for sh, (Rv, Rp) in zip(self.shards, rows):
            Rv_g = assemble((Rv * sh.valid).permute(2, 0, 1), sh.amap_v)
            Rp_g = assemble((Rp * sh.valid).T[:, :, None], sh.amap_p)
            if sh.hc_v is not None:
                Rv_g = sh.hc_v.distribute_transpose(Rv_g)
            if sh.hc_p is not None:
                Rp_g = sh.hc_p.distribute_transpose(Rp_g)
            rv.append(Rv_g)
            rp.append(Rp_g)
        rv = self.ex_v.combine(ShardVec(rv))
        rp = self.ex_p.combine(ShardVec(rp))
        return ShardVec(
            torch.cat([(a * sh.owned_v).reshape(-1),
                       (b * sh.owned_p).reshape(-1)]).masked_fill(m, 0.0)
            for sh, a, b, m in zip(self.shards, rv.parts, rp.parts, mask))

    def _lumped_pressure_mass(self) -> list:
        """Per shard the lumped pressure mass [Np_loc] (combined; 1 where
        it vanishes)."""
        parts = []
        for sh in self.shards:
            Bv, Gv, Bp, w = sh.tables
            J = torch.einsum("niE,qnj->qijE", sh.xe, Gv)
            detJ, _ = _det_inv_soa(J)
            lumped = torch.einsum("qn,qE->nE", Bp,
                                  detJ * w[:, None] * sh.valid)
            parts.append(assemble(lumped.T[:, :, None], sh.amap_p))
        mp = self.ex_p.combine(ShardVec(parts))
        return [torch.where(torch.abs(m) > 1e-300, m, torch.ones_like(m))
                for m in mp.parts]

    # ------------------------------------------------------------------
    def solve(self, x0_global, vprev_combo_global, t=0.0, alpha0=0.0):
        """One nonlinear solve from global state (the engine's hook):
        returns the ``NewtonResult`` with the global solution, hanging
        rows distributed."""
        op, solver = self.op, self.solver
        d = self.dim
        nu, gamma = op.nu, op.gamma
        alpha0 = float(alpha0)
        mask_loc = self.to_local(solver._mask.to(self.dtype))
        mask = [m > 0.5 for m in mask_loc.parts]
        vals = self.to_local(solver._bc_values_flat(t))
        x0 = ShardVec(torch.where(m, v, x) for x, m, v in zip(
            self.to_local(x0_global).parts, mask, vals.parts))
        combo = self.ex_v.refresh(self._velocity_local(vprev_combo_global))
        vpe, fq, mask_v = [], [], []
        for sh, cb, m in zip(self.shards, combo.parts, mask):
            vpe.append(cb[sh.cv_t].transpose(1, 2))
            if solver._mms is not None:
                f = solver._mms(sh.qpts, t)
            elif solver.source is not None:
                f = solver.source.spatial(sh.qpts, t)[..., :d]
            else:
                f = torch.zeros_like(sh.qpts)
            fq.append(f.to(self.dtype).permute(1, 2, 0))
            mask_v.append(m[:self.Lv.N_loc * d].reshape(-1, d))

        def element_residual(sh, k):
            Bv, Gv, Bp, w = sh.tables
            return lambda ve, pe: gd_soa_residual(
                ve, pe, vpe[k], sh.xe, fq[k], Bv, Gv, Bp, w, nu, gamma,
                alpha0)

        def residual(x):
            rows = [element_residual(sh, k)(*self._element_state(sh, lv, lp))
                    for k, (sh, (lv, lp)) in enumerate(
                        zip(self.shards, self._fresh(x)))]
            return self._finish(rows, mask)

        def jacobian(x):
            states = [self._element_state(sh, lv, lp) for sh, (lv, lp)
                      in zip(self.shards, self._fresh(x))]

            def matvec(dx):
                rows = []
                for k, (sh, (dv, dp)) in enumerate(
                        zip(self.shards, self._fresh(dx))):
                    _, dr = torch.func.jvp(
                        element_residual(sh, k), states[k],
                        self._element_state(sh, dv, dp))
                    rows.append(dr)
                return self._finish(rows, mask)

            return matvec

        schur_scale = -(nu + gamma)
        eye = torch.eye(d, dtype=self.dtype, device=self.devices[0])

        def precond_builder(x):
            binv = []
            parts = []
            for sh, (lv, _) in zip(self.shards, self._fresh(x)):
                Bv, Gv, Bp, w = sh.tables
                J = torch.einsum("niE,qnj->qijE", sh.xe, Gv)
                detJ, Jinv = _det_inv_soa(J)
                gB = torch.einsum("qna,qaiE->qniE", Gv, Jinv)
                ve = lv[sh.cv_t].transpose(1, 2)
                uq = torch.einsum("qn,ndE->qdE", Bv, ve)
                guq = torch.einsum("qniE,ndE->qdiE", gB, ve)
                blocks = element_velocity_blocks(
                    Bv, gB, detJ * w[:, None], uq, guq, alpha0, nu, gamma,
                    eye.to(sh.device)) * sh.valid
                parts.append(assemble(
                    blocks.reshape(blocks.shape[0], d * d, -1).permute(
                        2, 0, 1), sh.amap_v))
            blocks = self.ex_v.combine(ShardVec(parts))
            for sh, b, mv in zip(self.shards, blocks.parts, mask_v):
                e = eye.to(sh.device)
                mrow = mv.to(self.dtype)
                keep = 1.0 - mrow
                b = (b.reshape(-1, d, d) * keep[:, :, None]
                     * keep[:, None, :] + mrow[:, :, None] * e)
                # ghost rows (partial sums; their input is zero) invert as
                # identity: a zero block's determinant is no test in f32
                b = torch.where(sh.owned_v[:, :, None] > 0.5, b, e)
                binv.append(_invert_blocks(b, e))

            def apply(r):
                out = []
                for sh, rp_, bi, mp in zip(self.shards, r.parts, binv,
                                           self._mp):
                    rv, rp = self._split(rp_)
                    zv = torch.einsum("nij,nj->ni", bi, rv)
                    out.append(torch.cat([zv.reshape(-1),
                                          schur_scale * rp[:, 0] / mp[:, 0]]))
                return ShardVec(out)

            return apply

        res = newton_solve(residual, jacobian, x0,
                           precond_builder=precond_builder,
                           config=self.newton_cfg, reduce_fn=shard_sum)
        fresh = self._fresh(res.u)
        u = ShardVec(torch.cat([lv.reshape(-1), lp.reshape(-1)])
                     for lv, lp in fresh)
        return res._replace(u=self.to_global(u).to(solver.device))
