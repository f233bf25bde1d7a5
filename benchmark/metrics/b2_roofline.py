"""Kernel B2 (``csrc/gls_lattice.cu``) against its roofline: the bound
of every lattice call of the GLS operator in the traced window, from its
shape (``benchmark/roofline.py``), over the device time of the kernels
named in ``PATTERNS``, against the H100 SXM's published peaks at 700 W
(the run prints the card's power limit on standard error)."""

from benchmark.roofline import bound

PATTERNS = ("gls_lattice",)
LATTICE = True


def read(ctx):
    if ctx.trace is None:
        return None
    ms = sum(n * bound(d, k, variant, E, lattice, q)[0]
             for (d, k, q, E, lattice, variant), n in ctx.trace.calls.items()
             if lattice == LATTICE)
    spent = ctx.trace.device_s(PATTERNS)
    if not ms or not spent:
        return None
    return 100.0 * ms * 1e-3 / spent
