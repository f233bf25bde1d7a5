"""Solution transfer between forest meshes (SolutionTransfer equivalent;
counterpart of ``softx_2020_200_tpu.fem.transfer``, whose NumPy
functions are copied here unchanged).

The reference carries the present solution AND the BDF history across
every mesh adaptation via deal.II's ``SolutionTransfer`` (SURVEY.md §2.2,
hard part #4).  Here: every node of the NEW space has a known position in
its base cell's reference coordinates; walking the OLD forest down to the
containing old leaf gives (old element, local reference coords); the old
FE field is then evaluated there.  Interpolation is exact for fields in
the FE space (refinement) and is the standard injection for coarsening.
"""

from __future__ import annotations

import numpy as np
import torch


def _new_node_base_positions(space, forest, elem_of):
    """For each new global node: (base_cell, ref position in base cell).

    Uses one owning element per node (continuity makes any choice valid).
    """
    basis = space.basis
    N = space.n_nodes
    nn = basis.n_nodes
    bs, lvls, idxs = forest._leaf_arrays_only()
    idxs = idxs.astype(np.float64)
    h = 1.0 / (1 << lvls)                                  # [E]
    # one owning element per node: FIRST occurrence in element order
    flat = space.elem_nodes.reshape(-1)
    uniq, first = np.unique(flat, return_index=True)
    e_idx, n_idx = first // nn, first % nn
    base_cell = np.full(N, -1, dtype=np.int64)
    base_pos = np.zeros((N, space.dim))
    base_cell[uniq] = bs[e_idx]
    base_pos[uniq] = (idxs[e_idx] + basis.nodes[n_idx]) \
        * h[e_idx][:, None]
    return base_cell, base_pos


def _locate_in_forest_loop(base_cell, base_pos, forest, elem_of, dim):
    """Reference per-node walk (deep forests > level 15)."""
    N = base_cell.shape[0]
    elem = np.zeros(N, dtype=np.int64)
    ref = np.zeros((N, dim))
    for nid in range(N):
        b = int(base_cell[nid])
        pos = base_pos[nid]
        leaf = (0,) + (0,) * dim
        while leaf not in forest.leaves[b]:
            lvl, idx = leaf[0], leaf[1:]
            h = 1.0 / (1 << lvl)
            child_bits = 0
            for a in range(dim):
                local = pos[a] / h - idx[a]
                if local >= 0.5:
                    child_bits |= (1 << a)
            leaf = (lvl + 1,) + tuple(
                2 * idx[a] + ((child_bits >> a) & 1) for a in range(dim))
            if leaf[0] > 30:
                raise RuntimeError("forest walk failed")
        elem[nid] = elem_of[(b, leaf)]
        lvl, idx = leaf[0], leaf[1:]
        h = 1.0 / (1 << lvl)
        ref[nid] = np.clip(
            (pos - np.array(idx, dtype=np.float64) * h) / h, 0.0, 1.0)
    return elem, ref


_ENC_BITS = 15                     # per-axis index bits (level <= 15)


def _encode(b, lvl, idx):
    """int64 code for (base, level, i0..i_{d-1}) with i < 2^15."""
    code = b.astype(np.int64) * 16 + lvl
    for a in range(idx.shape[-1]):
        code = (code << _ENC_BITS) | idx[..., a]
    return code


def locate_in_forest(base_cell, base_pos, forest, elem_of, dim):
    """Leaf containing each (base cell, base-ref position):
    (elem [N], ref_in_leaf [N, dim]).

    Vectorized level-synchronous descent (one np.isin per level)
    instead of a per-node Python walk — the per-adaptation host cost at
    1M+ nodes drops from minutes to milliseconds (SURVEY §7.3 hard
    part #1)."""
    base_cell = np.asarray(base_cell, np.int64)
    base_pos = np.asarray(base_pos, np.float64)
    E = len(elem_of)
    rest = np.fromiter((x for k in elem_of for x in k[1]),
                       np.int64, E * (dim + 1)).reshape(E, dim + 1)
    klvl, kidx = rest[:, 0], rest[:, 1:]
    maxlvl = int(klvl.max(initial=0))
    if maxlvl >= _ENC_BITS or len(forest.leaves) >= (1 << 40):
        return _locate_in_forest_loop(base_cell, base_pos, forest,
                                      elem_of, dim)
    kb = np.fromiter((k[0] for k in elem_of), np.int64, E)
    kcode = _encode(kb, klvl, kidx)
    kelem = np.fromiter(elem_of.values(), np.int64, E)
    order = np.argsort(kcode)
    kcode_s, kelem_s = kcode[order], kelem[order]

    N = base_cell.shape[0]
    lvl = np.zeros(N, np.int64)
    idx = np.zeros((N, dim), np.int64)
    elem = np.full(N, -1, np.int64)
    active = np.ones(N, bool)
    for _ in range(maxlvl + 1):
        code = _encode(base_cell, lvl, idx)
        pos_s = np.searchsorted(kcode_s, code)
        pos_c = np.minimum(pos_s, kcode_s.size - 1)
        hit = active & (kcode_s[pos_c] == code)
        elem[hit] = kelem_s[pos_c[hit]]
        active &= ~hit
        if not active.any():
            break
        # descend one level at the still-active nodes
        h = 1.0 / (1 << lvl[active])
        local = base_pos[active] / h[:, None] - idx[active]
        bit = (local >= 0.5).astype(np.int64)
        idx[active] = 2 * idx[active] + bit
        lvl[active] += 1
    if active.any():
        raise RuntimeError("forest walk failed (unresolved nodes)")
    h = 1.0 / (1 << lvl)
    ref = np.clip(base_pos / h[:, None] - idx, 0.0, 1.0)
    return elem, ref


def transfer_solution(old_space, old_forest, old_elem_of,
                      new_space, new_forest, new_elem_of, fields):
    """Interpolate [N_old, c] field tensors onto the new space: list ->
    list, each on its field's device and in its dtype (evaluated on the
    host in float64, as in the JAX package)."""
    dim = new_space.dim
    base_cell, base_pos = _new_node_base_positions(
        new_space, new_forest, new_elem_of)
    old_elem, ref_in_old = locate_in_forest(
        base_cell, base_pos, old_forest, old_elem_of, dim)

    # evaluate the old basis at each node's reference coords
    Bpt = old_space.basis.tabulate_values(ref_in_old)      # [N, nn_old]
    conn = old_space.elem_nodes[old_elem]                  # [N, nn_old]
    out = []
    for f in fields:
        f_np = f.detach().cpu().numpy()
        vals = np.einsum("nk,nkc->nc", Bpt, f_np[conn], optimize=True)
        out.append(torch.as_tensor(vals, dtype=f.dtype, device=f.device))
    return out
