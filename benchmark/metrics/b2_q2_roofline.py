"""Kernel B2 (``csrc/gls_lattice.cu``) at degree 2 against its
roofline: the bound of every degree-2 lattice call of the GLS operator
in the traced window, from its shape (``benchmark/roofline.py``), over
the device time of the kernels named in ``PATTERNS``: B2's degree-2
instances as the card's trace prints them (the template arguments
dimension, degree and points per axis; degree 2 runs only the STAGED
route), against the H100 SXM's published peaks at 700 W (the run
prints the card's power limit on standard error)."""

from benchmark.roofline import bound

PATTERNS = ("gls_lattice_kernel<2, 2, 3,", "gls_lattice_kernel<3, 2, 3,")
DEGREE = 2


def read(ctx):
    if ctx.trace is None:
        return None
    ms = sum(n * bound(d, k, variant, E, lattice, q)[0]
             for (d, k, q, E, lattice, variant), n in ctx.trace.calls.items()
             if lattice and k == DEGREE)
    spent = ctx.trace.device_s(PATTERNS)
    if not ms or not spent:
        return None
    return 100.0 * ms * 1e-3 / spent
