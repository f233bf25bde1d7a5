"""Morton (space-filling-curve) element partitioning (a copy of
``softx_2020_200_tpu.parallel.partition``; only its imports may differ).

Host-side equivalent of p4est's SFC partition: elements are ordered
along a Morton curve over quantized centroids and split into P
contiguous ranges, one per shard.  Each shard owns its elements, owns
the nodes whose lowest-touching shard it is, and keeps ghost copies of
the nodes its elements share with neighboring ranges.  The exchange plan
(who sends which local slots to whom) is precomputed here as static
index arrays; at run time each exchange is one hop between devices
(``parallel/sharded.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def morton_order(centroids: np.ndarray, bits: int = 16) -> np.ndarray:
    """Return element permutation sorting centroids along a Morton curve."""
    E, dim = centroids.shape
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    q = ((centroids - lo) / span * (2 ** bits - 1)).astype(np.uint64)
    from ..native import morton_codes
    code = morton_codes(q, bits)
    if code is None:
        code = np.zeros(E, dtype=np.uint64)
        for b in range(bits):
            for d in range(dim):
                code |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << \
                    np.uint64(b * dim + d)
    return np.argsort(code, kind="stable")


@dataclass
class Exchange:
    """One ppermute hop: shard p sends local slots send_idx[p] to shard
    p+delta, which writes them into its local slots recv_idx[p+delta]."""
    delta: int
    send_idx: np.ndarray    # [P, S] int32 (trash slot when invalid)
    recv_idx: np.ndarray    # [P, S] int32
    valid: np.ndarray       # [P, S] float (1 where a real transfer)


@dataclass
class ShardLayout:
    n_shards: int
    dim: int
    degree: int
    n_nodes_global: int
    N_loc: int              # local node slots incl. trailing trash slot
    E_loc: int              # local element slots (padded)
    nn: int
    elem_nodes: np.ndarray  # [P, E_loc, nn] int32 local ids
    elem_valid: np.ndarray  # [P, E_loc] float
    xe: np.ndarray          # [P, E_loc, nn, dim]
    owned_mask: np.ndarray  # [P, N_loc] float (1 = owned real node)
    l2g: np.ndarray         # [P, N_loc] int64 (-1 = unused/trash)
    # gather-based assembly maps (ops.operators.AssemblyMap per shard,
    # padded to a common multiplicity): [P, N_loc, M] into [E_loc*nn (+1)]
    assembly_idx: np.ndarray = None  # type: ignore[assignment]
    exchanges: list[Exchange] = field(default_factory=list)

    # ------------------------------------------------------------------
    def to_local(self, u_global: np.ndarray) -> np.ndarray:
        """[N, c] -> [P, N_loc, c] (ghosts filled too)."""
        c = u_global.shape[-1]
        out = np.zeros((self.n_shards, self.N_loc, c), u_global.dtype)
        valid = self.l2g >= 0
        out[valid] = u_global[self.l2g[valid]]
        return out

    def to_global(self, u_stack: np.ndarray) -> np.ndarray:
        """[P, N_loc, c] -> [N, c] from owned entries."""
        c = u_stack.shape[-1]
        out = np.zeros((self.n_nodes_global, c), u_stack.dtype)
        own = (self.owned_mask > 0)
        out[self.l2g[own]] = u_stack[own]
        return out


def partition_space(space, n_shards: int, hc=None,
                    elem_order=None) -> ShardLayout:
    """Build the shard layout for an FESpace over n_shards devices.

    ``hc`` (HangingConstraints) closes each shard's node set over the
    MASTERS of any hanging node the shard touches, so constraint rows
    can be applied shard-locally after a ghost refresh (the distributed
    analogue of deal.II's locally_relevant_dofs including constraint
    dependencies — SURVEY.md §2.2 setup_dofs).

    ``elem_order`` overrides the Morton element permutation — mixed
    (Taylor-Hood) discretizations partition their velocity and pressure
    spaces with the SAME element ranges so every element is wholly
    owned by one shard in both spaces."""
    P = n_shards
    elem_nodes = space.elem_nodes            # [E, nn] int32 global
    coords = space.element_coords()          # [E, nn, dim]
    E, nn = elem_nodes.shape
    dim = space.dim

    order = (elem_order if elem_order is not None
             else morton_order(coords.mean(axis=1)))
    # contiguous ranges of the Morton order
    bounds = np.linspace(0, E, P + 1).astype(np.int64)
    shard_elems = [order[bounds[p]:bounds[p + 1]] for p in range(P)]

    # node ownership: lowest shard touching the node
    owner = np.full(space.n_nodes, P, dtype=np.int64)
    for p in range(P - 1, -1, -1):
        owner[np.unique(elem_nodes[shard_elems[p]])] = p

    hc_ids = hc_masters = None
    if hc is not None and hc.n:
        hc_ids = np.asarray(hc.ids, dtype=np.int64)
        hc_masters = np.asarray(hc.masters, dtype=np.int64)

    # local numbering per shard: owned first, then ghosts (sorted by
    # owner then global id, so exchange slices are deterministic)
    locals_g: list[np.ndarray] = []
    for p in range(P):
        touched = np.unique(elem_nodes[shard_elems[p]])
        if hc_ids is not None:
            # masters of touched hanging nodes become ghosts too (on a
            # 2:1 forest masters are genuine DoFs, one closure suffices)
            sel = np.isin(hc_ids, touched)
            if sel.any():
                touched = np.union1d(touched,
                                     np.unique(hc_masters[sel]))
        own = touched[owner[touched] == p]
        # owned-but-untouched nodes can't exist (owner touches them)
        ghosts = touched[owner[touched] != p]
        ghosts = ghosts[np.argsort(owner[ghosts] * space.n_nodes + ghosts,
                                   kind="stable")]
        locals_g.append(np.concatenate([own, ghosts]))

    N_loc = max(len(v) for v in locals_g) + 1     # +1 trash slot
    E_loc = max(len(s) for s in shard_elems)
    trash = N_loc - 1

    l2g = np.full((P, N_loc), -1, dtype=np.int64)
    owned_mask = np.zeros((P, N_loc), dtype=np.float64)
    # vectorized global->local maps (per-node dicts are O(N) python —
    # unusable at the 10M-DoF scale this path exists for)
    g2l_arr = np.full((P, space.n_nodes), trash, dtype=np.int32)
    for p in range(P):
        v = locals_g[p]
        l2g[p, :len(v)] = v
        owned_mask[p, :len(v)] = (owner[v] == p)
        g2l_arr[p, v] = np.arange(len(v), dtype=np.int32)

    en_loc = np.full((P, E_loc, nn), trash, dtype=np.int32)
    ev = np.zeros((P, E_loc), dtype=np.float64)
    xe = np.zeros((P, E_loc, nn, dim), dtype=np.float64)
    # padding elements get a unit reference cell so the geometry stays
    # invertible (their contribution is masked out anyway)
    from ..fem.basis import TensorBasis
    ref_nodes = TensorBasis(dim, space.degree).nodes
    xe[:] = ref_nodes[None, None, :, :]
    for p in range(P):
        es = shard_elems[p]
        en_loc[p, :len(es)] = g2l_arr[p, elem_nodes[es]]
        ev[p, :len(es)] = 1.0
        xe[p, :len(es)] = coords[es]

    # exchange plans: for each rank distance delta, shard p sends the
    # owned values that shard p+delta holds as ghosts
    needs: dict[int, list[tuple[int, np.ndarray]]] = {}
    for q in range(P):
        gl = locals_g[q]
        gown = owner[gl]
        for p in np.unique(gown):
            if p == q:
                continue
            ghosts_from_p = gl[gown == p]          # global ids
            needs.setdefault(int(q - p), []).append((int(p), ghosts_from_p))

    exchanges: list[Exchange] = []
    for delta, pairs in sorted(needs.items()):
        S = max(len(g) for _, g in pairs)
        send_idx = np.full((P, S), trash, dtype=np.int32)
        recv_idx = np.full((P, S), trash, dtype=np.int32)
        valid = np.zeros((P, S), dtype=np.float64)
        for p, ghosts in pairs:
            q = p + delta
            send_idx[p, :len(ghosts)] = g2l_arr[p, ghosts]
            recv_idx[q, :len(ghosts)] = g2l_arr[q, ghosts]
            valid[q, :len(ghosts)] = 1.0
        exchanges.append(Exchange(delta=delta, send_idx=send_idx,
                                  recv_idx=recv_idx, valid=valid))

    # per-shard gather-based assembly maps (exclude the trash slot),
    # padded to a common max multiplicity across shards
    from ..ops.operators import build_assembly_map
    amaps = [build_assembly_map(en_loc[p], N_loc, exclude_node=trash)
             for p in range(P)]
    M = max(a.max_multiplicity for a in amaps)
    pad = E_loc * nn
    assembly_idx = np.full((P, N_loc, M), pad, dtype=np.int32)
    for p, a in enumerate(amaps):
        ai = np.asarray(a.idx)
        assembly_idx[p, :, :ai.shape[1]] = ai

    return ShardLayout(
        n_shards=P, dim=dim, degree=space.degree,
        n_nodes_global=space.n_nodes, N_loc=N_loc, E_loc=E_loc, nn=nn,
        elem_nodes=en_loc, elem_valid=ev, xe=xe,
        owned_mask=owned_mask, l2g=l2g, assembly_idx=assembly_idx,
        exchanges=exchanges)
