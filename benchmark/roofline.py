"""The yardstick of the kernels' roofline shares: the H100's published
peaks and the least time one call of the GLS element kernels (B1 on any
mesh, B2 on a lattice) needs, from its shape alone.  A frozen copy of
``chip_smoke.py``'s ``_bound``, ``_bound_of`` and ``_build_of``: each
input row read once, each output written once, against the card's HBM
rate, and the operations against its float32 rate outside the tensor
cores; the larger of the two is the bound."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bytes/s and float32 operations/s
# outside the tensor cores, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def build_of(variant: str) -> tuple[str, int, int]:
    """(mode, state bytes, operand bytes) of a variant: "... bf16" has
    bf16 state rows only, "... bf16op" every operand and the output in
    bf16."""
    if variant.endswith(" bf16op"):
        return variant[:-len(" bf16op")], 2, 2
    if variant.endswith(" bf16"):
        return variant[:-len(" bf16")], 2, 4
    return variant, 4, 4


def bound(dim: int, degree: int, variant: str, E: int, lattice: bool,
          n_q1d: int | None = None):
    """(bound_ms, bound_by) of one call of ``variant`` ("primal",
    "tangent" or "probe": the nn*c probes of one node-block call) on E
    elements with ``n_q1d`` Gauss points per axis (k + 1 by default).
    Operations count 2 per multiply-add of the contractions, and the
    pointwise physics as the kernels write it (about 5d^2 + 14d + 12 a
    point, 4d^2 + 8d more for a tangent)."""
    variant, state_bytes, operand_bytes = build_of(variant)
    d, n1 = dim, degree + 1
    nn, nq = n1 ** d, (n_q1d or n1) ** d
    c = d + 1
    pw = 5 * d * d + 14 * d + 12
    dpw = 4 * d * d + 8 * d
    if lattice:
        M, Mnl = (d + 2) * nq, (d + 1) * nq
        interp = 2 * nn * (d * M + Mnl + d * nq)       # u, p, u^{n-i}
        proj = 2 * nn * (d * M + Mnl)
        dinterp = 2 * nn * (d * M + Mnl)
        primal_ops = interp + proj + nq * pw
        inputs = c * nn + d * nn + d * nq
    else:
        per_q = (2 * d * d * nn + (45 if d == 3 else 10) + 2 * d ** 3
                 + 2 * nn * d * d + 2 * c * nn * (1 + d) + 2 * c * d * d
                 + 4 * d * nn + pw + 2 * d ** 3 + 2 * d * d
                 + nn * (d * (4 + 2 * d) + 2 + 2 * d))
        dinterp = nq * (2 * c * nn * (1 + d) + 2 * c * d * d + 2 * d * nn)
        primal_ops = nq * per_q
        inputs = c * nn + 2 * d * nn + d * nq + 1     # ue, xe, up, fq, h
    if variant == "primal":
        ops, words = primal_ops, c * nn
    elif variant == "tangent":
        ops, words = primal_ops + dinterp + nq * dpw, 2 * c * nn
    else:   # node blocks: nn*c probes, each without a direction stream
        ops = nn * c * (primal_ops + nq * dpw)
        words = nn * c * c
    return bound_of(ops, 0, E,
                    nbytes=state_bytes * inputs + operand_bytes * words)


def bound_of(ops: float, words: float, E: int, nbytes: float | None = None):
    """The bound of ``ops`` operations and ``words`` f32 words (or
    ``nbytes`` bytes) per element, on E elements."""
    nbytes = 4.0 * words if nbytes is None else nbytes
    t_bytes = nbytes * E / PEAK_BYTES_PER_S
    t_ops = float(ops) * E / PEAK_F32_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")
