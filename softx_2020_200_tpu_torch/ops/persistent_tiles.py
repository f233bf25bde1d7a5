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
  for f32 rows, a bf16 pitch that is a multiple of 8, and 16-byte aligned
  base pointers (a TMA row pitch must be a multiple of 16 bytes);
- ``LOAD_CP_ASYNC_4`` takes any f32 pitch (E % 4 != 0, as on a lattice of
  195 elements, or a tensor that starts mid-row) and any even bf16 pitch
  on 4-byte aligned rows.

The frozen linearization state of B1 and B2 may be bf16 (``jacobian
state precision = bf16``): ``state_rows`` rounds it once per
linearization into rows whose pitch is E rounded up to 8 elements, so that
both paths take it at any E; the kernels widen each element to f32 where
they read it.

The bf16-operand instances of B1, B2 and B3 (an operator built with
``dtype=torch.bfloat16``) take every row in bf16, the direction too, at
one even pitch (``narrow_rows`` lays them out at the pitch of
``state_rows``), bf16 tables, and write a bf16 output at the rows' pitch
(``empty_rows``); their arithmetic is f32.
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


def table_words(n: int, elem_bytes: int = 4) -> int:
    """Words (4 bytes) of a table of ``n`` entries of ``elem_bytes`` in
    shared memory, rounded up to 128 bytes (``tiles::table_words``)."""
    return pad32(-(-n * elem_bytes // 4))


def stage_floats(rows, be: int, elem_bytes=None) -> int:
    """Words (4 bytes) of one ring stage holding an R x ``be`` box of each
    input (``rows`` per input, 0 for one the variant does not read), of
    ``elem_bytes`` per element (per input; 4 for all by default), each box
    rounded up to 128 bytes."""
    elem_bytes = elem_bytes or (4,) * len(rows)
    return sum(pad32(r * be * e // 4) for r, e in zip(rows, elem_bytes))


STATE_PITCH_ALIGN = 8


def state_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` [..., E] rounded to bf16 once, as a view [..., E] into rows
    whose pitch is E rounded up to ``STATE_PITCH_ALIGN`` elements (16
    bytes: a TMA row pitch), zero-padded.  Rounds through f32 (an f64
    value is rounded to f32 first), as ``x.float().bfloat16()`` does."""
    E = x.shape[-1]
    pitch = -(-E // STATE_PITCH_ALIGN) * STATE_PITCH_ALIGN
    out = torch.zeros(*x.shape[:-1], pitch, dtype=torch.bfloat16,
                      device=x.device)
    out[..., :E] = x.float()
    return out[..., :E]


def narrow_pitch(E: int) -> int:
    """The row pitch of ``state_rows`` for rows of E elements: E rounded
    up to ``STATE_PITCH_ALIGN``."""
    return -(-E // STATE_PITCH_ALIGN) * STATE_PITCH_ALIGN


def narrow_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` [..., E] as bf16 rows at the pitch ``state_rows`` lays out:
    ``x`` itself where it is so already (bf16 at that pitch, 16-byte
    aligned), else ``state_rows(x)``."""
    if (x.dtype == torch.bfloat16 and x.data_ptr() % 16 == 0
            and row_pitch(x) == narrow_pitch(x.shape[-1])):
        return x
    return state_rows(x)


def empty_rows(shape, pitch: int, device) -> torch.Tensor:
    """An uninitialised bf16 output [..., E] whose rows lie at ``pitch``
    elements (the input rows' pitch of a bf16-operand launch)."""
    *lead, E = shape
    return torch.empty(*lead, max(pitch, E), dtype=torch.bfloat16,
                       device=device)[..., :E]


def launch_output(rows: torch.Tensor, shape, operand_bytes: int):
    """The output ``shape`` of a launch on ``rows``: float32, or for bf16
    operands (``operand_bytes`` 2) bf16 at the rows' pitch."""
    if operand_bytes == 2:
        return empty_rows(shape, row_pitch(rows) or shape[-1], rows.device)
    return rows.new_empty(shape, dtype=torch.float32)


def row_pitch(t: torch.Tensor) -> int | None:
    """The row pitch (elements) of ``t`` [..., E] when its rows lie at one
    pitch with unit element stride, as ``state_rows`` and a contiguous
    tensor lay them out (E for a single row); None otherwise."""
    *lead, E = t.shape
    strides = t.stride()
    if strides[-1] != 1:
        return None
    if not lead:
        return E
    pitch = size = strides[-2]
    for n, stride in zip(reversed(lead), reversed(strides[:-1])):
        if stride != size and n != 1:
            return None
        size *= n
    return pitch if pitch >= E else None


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


def load_path(n_elements: int, data_ptrs, pitch_bytes=None) -> int:
    """The load path for input rows at ``data_ptrs``, with the row pitches
    ``pitch_bytes`` (bytes; by default the f32 rows' 4 * ``n_elements``; a
    bf16 state row's is 2 x its pitch): TMA when every row starts on a
    16-byte boundary, else 4-byte ``cp.async``."""
    pitch_bytes = [4 * n_elements] if pitch_bytes is None else pitch_bytes
    # every row pitch and every base address, on 16 bytes
    aligned = not functools.reduce(operator.or_, [*pitch_bytes, *data_ptrs],
                                   0) & 15
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


def state_bytes(t: torch.Tensor) -> int:
    """Bytes per element of a launch's state rows (or, of a bf16-operand
    launch, of every row, table and output): 2 for bf16, else 4."""
    return 2 if t.dtype == torch.bfloat16 else 4


def check_rows(kernel: str, device: int, state, f32) -> int:
    """Checks one launch's tensors on the CUDA ``device`` (index):
    ``f32`` [(tensor, shape)] contiguous float32; ``state`` [(tensor,
    shape)], the frozen state rows, all float32 and contiguous, or all
    bf16 at one even row pitch with 4-byte aligned rows (``state_rows``
    lays them out so).  A bf16-operand launch passes every tensor, the
    direction, the tables and the output included, in ``state`` and none
    in ``f32``.  Returns the state rows' pitch in elements; raises
    ValueError on anything the kernel does not take."""
    bf16 = state[0][0].dtype == torch.bfloat16
    for t, shape in f32 if bf16 else f32 + state:
        if (t.shape != shape or t.dtype != torch.float32
                or t.get_device() != device or not t.is_contiguous()):
            raise ValueError(
                f"CUDA {kernel} kernel takes contiguous float32 tensors on "
                f"cuda:{device}: got {tuple(t.shape)} {t.dtype} on "
                f"{t.device} where {shape} was expected")
    if not bf16:
        return state[0][1][-1]
    pitches = set()
    for t, shape in state:
        pitch = row_pitch(t)
        if (t.shape != shape or t.dtype != torch.bfloat16
                or t.get_device() != device or pitch is None
                or t.data_ptr() % 4 or (pitch % 2 and len(shape) > 1)):
            raise ValueError(
                f"CUDA {kernel} kernel takes bf16 state rows at an even row "
                f"pitch, 4-byte aligned, on cuda:{device}: got "
                f"{tuple(t.shape)} {t.dtype} on {t.device} (strides "
                f"{t.stride()}) where {shape} was expected")
        if len(shape) > 1:
            pitches.add(pitch)
    if len(pitches) != 1:
        raise ValueError(f"CUDA {kernel} kernel: the state rows lie at "
                         f"different row pitches {sorted(pitches)}")
    return pitches.pop()
