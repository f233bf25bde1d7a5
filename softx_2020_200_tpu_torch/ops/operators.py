"""Element gather and gather-sum assembly (counterpart of
``softx_2020_200_tpu.ops.operators``).

Assembly stays GATHER + sum, never ``index_add_``: the mesh is static, so
for every node the (element, local-node) slots that feed it are found
once on the host (``AssemblyMap``), and assembly becomes a dense gather
of at most ``max_multiplicity`` contributions followed by a sum over that
small axis.  The sum runs in a fixed order on every device, where the
atomics behind ``index_add_`` on a GPU add in no fixed order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.spans import take


@dataclass(frozen=True)
class AssemblyMap:
    """Static inverse connectivity: ``idx[N, M]`` indexes the FLATTENED
    [E*nn (+1)] contribution array; padding entries point at the
    trailing zero slot ``n_flat``."""
    idx: torch.Tensor     # [N, M] int64 (host)
    n_flat: int           # E*nn
    max_multiplicity: int


def build_assembly_map(elem_nodes: np.ndarray, n_nodes: int,
                       exclude_node: int | None = None) -> AssemblyMap:
    """Host-side construction of the gather-based assembly map (the
    native meshkit builds it when the library compiles; NumPy
    otherwise).  ``exclude_node`` drops the contributions to that node
    (a shard layout's trash slot, which its padding elements name)."""
    E, nn = elem_nodes.shape
    flat_nodes = elem_nodes.reshape(-1).astype(np.int64)
    if exclude_node is not None:
        flat_nodes = np.where(flat_nodes == exclude_node, n_nodes,
                              flat_nodes)
    counts = np.bincount(flat_nodes[flat_nodes < n_nodes],
                         minlength=n_nodes)
    M = int(counts.max()) if counts.size else 0

    from ..native import assembly_map as native_amap
    nat = native_amap(elem_nodes, n_nodes, exclude_node, max(M, 1), E * nn)
    if nat is not None:
        idx, used = nat
        return AssemblyMap(idx=torch.from_numpy(idx.astype(np.int64)),
                           n_flat=E * nn, max_multiplicity=used)

    order = np.argsort(flat_nodes, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    idx = np.full((n_nodes, M), E * nn, dtype=np.int64)  # pad -> zero slot
    for m in range(M):
        has = counts > m
        idx[has, m] = order[starts[has] + m]
    return AssemblyMap(idx=torch.from_numpy(idx), n_flat=E * nn,
                       max_multiplicity=M)


def assemble(r_el, amap_idx, site: str | None = None,
             part: str | None = None):
    """r_el[E, nn, c] (any strides) -> [N, c]: gather-sum through the
    assembly map ``amap_idx[N, M]``; its gather is counted under the
    caller's ``site`` (and ``part``, ``core/spans.py``) when one is
    given."""
    E, nn, c = r_el.shape
    flat = r_el.new_empty((E * nn + 1, c))
    flat[:E * nn].view(E, nn, c).copy_(r_el)
    flat[E * nn].zero_()
    rows = (flat[amap_idx] if site is None
            else take(site, flat, amap_idx, part))
    return rows.sum(dim=1)


def node_multiplicity(elem_nodes: np.ndarray, n_nodes: int) -> np.ndarray:
    """Number of elements touching each node (host-side)."""
    mult = np.zeros(n_nodes, dtype=np.float64)
    np.add.at(mult, elem_nodes.reshape(-1), 1.0)
    return mult
