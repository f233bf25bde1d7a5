"""Node-block preconditioners for the matrix-free Newton-Krylov solves
(counterpart of ``softx_2020_200_tpu.ops.preconditioners``).

- ``jacobi``       — pointwise diagonal scaling.
- ``block_jacobi`` — per-node (d+1)x(d+1) blocks: couples the velocity
                     components and pressure at each node.

Both are built from the assembled node-diagonal Jacobian blocks
(``GLSOperator.node_blocks``) and applied as batched small dense algebra.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

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
