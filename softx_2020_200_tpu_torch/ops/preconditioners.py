"""Node-block preconditioners for the matrix-free Newton-Krylov solves
(counterpart of ``softx_2020_200_tpu.ops.preconditioners``).

- ``jacobi``       — pointwise diagonal scaling.
- ``block_jacobi`` — per-node (d+1)x(d+1) blocks: couples the velocity
                     components and pressure at each node.
- ``additive_schwarz`` — restricted additive Schwarz with one block per
                     element: batched inverses of the nn*(d+1) element
                     matrices (``GLSOperator.element_matrices``), applied
                     as a gather, one batched product and an assembly.

The first two are built from the assembled node-diagonal Jacobian blocks
(``GLSOperator.node_blocks``); all three are applied as batched small
dense algebra.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..core.spans import take
from .operators import assemble
from .smallmat import det_bm, inv_bm


@dataclass(frozen=True)
class Preconditioner:
    apply: Callable      # v[N, c] -> M^{-1} v  [N, c]


def _invert_blocks(blocks, eye):
    """Closed-form batched inverse of [N, c, c] blocks (degenerate ->
    identity), in batch-minor layout."""
    bm = blocks.permute(1, 2, 0)
    deg = torch.abs(det_bm(bm)) < 1e-300
    bm = torch.where(deg[None, None, :], eye[:, :, None], bm)
    return inv_bm(bm).permute(2, 0, 1)


def _with_identity_rows(blocks, bc_mask):
    """Constrained rows/cols arrive zeroed; they become identity."""
    nc = blocks.shape[-1]
    eye = torch.eye(nc, dtype=blocks.dtype, device=blocks.device)
    if bc_mask is not None:
        mrow = bc_mask.to(blocks.dtype)
        blocks = blocks + mrow[:, :, None] * eye
    return blocks, eye


def build_from_node_blocks(kind: str, blocks, bc_mask) -> Preconditioner:
    """Jacobi / block-Jacobi from pre-assembled node-diagonal blocks
    [N, c, c]."""
    if kind == "jacobi":
        blocks, _ = _with_identity_rows(blocks, bc_mask)
        diag = torch.diagonal(blocks, dim1=1, dim2=2)
        diag = torch.where(torch.abs(diag) > 1e-300, diag,
                           torch.ones_like(diag))
        return Preconditioner(apply=lambda v: v / diag)
    state = node_blocks_to_state(kind, blocks, bc_mask)
    return Preconditioner(apply=lambda v: apply_node_block_state(state, v))


def node_blocks_to_state(kind: str, blocks, bc_mask):
    """Pure-tensor preconditioner state (for skip-Newton carrying):
    jacobi -> inverse diagonal [N, c]; block_jacobi -> block inverses
    [N, c, c]."""
    blocks, eye = _with_identity_rows(blocks, bc_mask)
    if kind == "jacobi":
        diag = torch.diagonal(blocks, dim1=1, dim2=2)
        one = torch.ones_like(diag)
        return 1.0 / torch.where(torch.abs(diag) > 1e-300, diag, one)
    if kind != "block_jacobi":
        raise ValueError(f"unknown node-block preconditioner {kind!r}")
    return _invert_blocks(blocks, eye)


def apply_node_block_state(state, v):
    if state.ndim == 2:           # jacobi inverse diagonal
        return v * state
    return torch.einsum("nij,nj->ni", state, v)


def build_additive_schwarz(A_e, elem_nodes, amap_idx, inv_mult,
                           bc_mask) -> Preconditioner:
    """Restricted additive Schwarz with element blocks:

        z = sum_e R_e^T W_e (A_e + s_e I)^-1 R_e v,  W_e = 1/multiplicity

    so that overlapping contributions average.  The steady local blocks
    carry exact null modes (the constant pressure of a floating element);
    the relative shift s_e = 1e-3 max|diag A_e| makes every block
    invertible.  ``A_e`` [E, nn*c, nn*c] (row n*c + i, the order of
    ``v[elem_nodes]``) is overwritten; its inverses are the state."""
    E, nloc, _ = A_e.shape
    nn = elem_nodes.shape[1]
    c = nloc // nn
    diag = A_e.diagonal(dim1=1, dim2=2)
    dmax = diag.abs().amax(dim=-1, keepdim=True)
    diag.add_(1e-3 * dmax)
    Ainv = torch.linalg.inv(A_e)                    # [E, nn*c, nn*c]
    weight = take("smoother", inv_mult, elem_nodes)[:, :, None]  # [E, nn, 1]

    def apply(v):
        ve = take("smoother", v, elem_nodes).reshape(E, nloc, 1)
        ze = torch.bmm(Ainv, ve).view(E, nn, c) * weight
        return torch.where(bc_mask, v, assemble(ze, amap_idx, "smoother"))

    return Preconditioner(apply=apply)
