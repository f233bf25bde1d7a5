"""Host side of the persistent-tile skeleton of the kernels
(``csrc/persistent_tiles.cuh``): the grid size, the load path per launch
and the shared-memory budget, in Python so that the CPU tests reach them.

A launch of ``csrc/gls_element.cu`` (B1), ``csrc/gls_lattice.cu`` (B2)
or ``csrc/gd_lattice.cu`` (B3) is a persistent grid: at most as many
blocks as fit on the card at once, each walking element tiles of ``be``
elements.  A tile's input rows ``[R, E]`` arrive in a ring of two
shared-memory stages by one of two load paths, which need different row
pitches:

- ``LOAD_TMA`` needs every row to start on a 16-byte boundary: E % 4 == 0
  and 16-byte aligned base pointers (a TMA row pitch must be a multiple
  of 16 bytes);
- ``LOAD_CP_ASYNC_4`` takes any pitch (E % 4 != 0, as on a lattice of
  195 elements, or a tensor that starts mid-row).
"""

from __future__ import annotations

import functools
import operator

import torch

LOAD_CP_ASYNC_4, LOAD_TMA = 0, 1
# the two routes of B1, B2 and B3: STAGED (tiles through the ring; B1 and
# B2 one thread per point, then one per node; B3 one per pencil of its
# sum-factorized passes) and REGISTERS (one thread per element, its state
# in registers), on the shapes that compile it
STAGED, REGISTERS = 0, 1
ROUTES = ("auto", "staged", "registers")
STAGES = 2
# shared memory one block may use on an H100 (232,448 bytes)
SMEM_LIMIT = 227 * 1024
# TMA box dimensions are at most 256 elements
TMA_BOX_MAX = 256


def pad32(n: int) -> int:
    """``n`` floats rounded up to 32 (128 bytes, a TMA destination's
    alignment)."""
    return (n + 31) // 32 * 32


def stage_floats(rows, be: int) -> int:
    """Floats of one ring stage holding an R x ``be`` box of each input
    (``rows`` per input, 0 for one the variant does not read)."""
    return sum(pad32(r * be) for r in rows)


def persistent_grid(n_elements: int, be: int, blocks_per_sm: int,
                    n_sms: int) -> int:
    """Blocks of one launch: one per tile of ``be`` elements, at most as
    many as fit on the card at once (the occupancy times the SM count).
    0 for no elements."""
    if n_elements <= 0:
        return 0
    if blocks_per_sm < 1:
        raise ValueError("the kernel does not fit on an SM "
                         f"(occupancy {blocks_per_sm})")
    tiles = -(-n_elements // be)
    return min(tiles, blocks_per_sm * n_sms)


def sm_count(device) -> int:
    """The SM count of a CUDA ``device`` (a device or its index)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def load_path(n_elements: int, data_ptrs) -> int:
    """The load path for inputs ``[R, n_elements]`` at ``data_ptrs``: TMA
    when every row starts on a 16-byte boundary, else 4-byte
    ``cp.async``."""
    # the row pitch in bytes and every base address, on 16 bytes
    aligned = not functools.reduce(operator.or_, data_ptrs,
                                   4 * n_elements) & 15
    return LOAD_TMA if aligned else LOAD_CP_ASYNC_4


def choose_route(route: str, has_registers: bool, n_elements: int,
                 min_per_sm: int, n_sms: int) -> int:
    """STAGED or REGISTERS for one launch.  ``route`` "auto" takes
    REGISTERS where the shape has it and there are at least
    ``min_per_sm`` elements per SM (one thread per element fills the card
    only then), STAGED otherwise; "staged" and "registers" force one
    (registers only where the shape has it)."""
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r} (one of {ROUTES})")
    if not has_registers or route == "staged":
        return STAGED
    if route == "registers":
        return REGISTERS
    return REGISTERS if n_elements >= min_per_sm * n_sms else STAGED


def split_for(n_elements: int, candidates, n_sms: int, threads: int) -> int:
    """Threads per element on a REGISTERS route that splits an element's
    points: the largest split of ``candidates`` [(split, blocks per SM of
    that variant), ...] whose threads (``n_elements`` times the split)
    still fit on the card at once; 1 if none does."""
    best = 1
    for split, blocks_per_sm in candidates:
        if n_elements * split <= blocks_per_sm * n_sms * threads:
            best = max(best, split)
    return best
