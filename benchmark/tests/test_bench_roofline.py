"""The benchmark's frozen bound arithmetic equals ``chip_smoke.py``'s at
the shapes the cells launch."""

import pytest

import chip_smoke
from benchmark import roofline

SHAPES = [
    # TGV 96^3 and 48^3 with their lattice levels (Q1, 2 points per axis)
    (3, 1, 2, 96 ** 3, True), (3, 1, 2, 48 ** 3, True),
    (3, 1, 2, 24 ** 3, True), (3, 1, 2, 12 ** 3, True),
    (3, 1, 2, 6 ** 3, True),
    # the Q2 cylinder at refinement 5 and its forest levels (Q2, then Q1
    # with 3 points per axis under the p-level, then Q1)
    (2, 2, 3, 27648, False), (2, 1, 3, 27648, False),
    (2, 1, 2, 6912, False), (2, 1, 2, 27, False),
]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", ["primal", "tangent", "probe",
                                     "tangent bf16", "probe bf16op"])
def test_bound_is_chip_smokes(shape, variant):
    dim, degree, q1d, E, lattice = shape
    assert roofline.bound(dim, degree, variant, E, lattice, q1d) == \
        chip_smoke._bound(dim, degree, variant, E, lattice, q1d)


def test_peaks_are_chip_smokes():
    assert roofline.PEAK_BYTES_PER_S == chip_smoke.PEAK_BYTES_PER_S
    assert roofline.PEAK_F32_PER_S == chip_smoke.PEAK_F32_PER_S
