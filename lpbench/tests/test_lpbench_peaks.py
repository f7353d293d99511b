"""The bytes a solve needs, against sums done by hand."""
from __future__ import annotations

import pytest

from lpbench import peaks


def test_kernel_bytes_fig3_float32():
    # 16,384 problems of 256 constraints: 3 x 4 bytes a constraint, and a
    # problem's c (8), m_valid (4), x (8) and flag (4).
    B, m = 16384, 256
    assert peaks.kernel_bytes(B, B * m, "float32") == \
        12 * B * m + 24 * B == 50_724_864


@pytest.mark.parametrize("B,m,dtype,nbytes", [
    # fig3-m2048-f64.b2048: 3 x 8 bytes a constraint; c (16), m_valid (4),
    # x (16) and flag (4) a problem
    (2048, 2048, "float64", 24 * 2048 * 2048 + 40 * 2048),
    # fig4-m64.b131072: the 64 constraints held, not the 128 padded to
    (131072, 64, "float32", 12 * 131072 * 64 + 24 * 131072),
])
def test_kernel_bytes_of_the_other_batch_cells(B, m, dtype, nbytes):
    assert peaks.kernel_bytes(B, B * m, dtype) == nbytes
    assert peaks.solve_bytes(B, B * m, dtype) == \
        nbytes + B * peaks.ITEMSIZE[dtype]


def test_solve_bytes_adds_the_objective():
    assert peaks.solve_bytes(128, 128 * 256, "float32") == \
        12 * 128 * 256 + 24 * 128 + 4 * 128
    assert peaks.solve_bytes(2, 10, "float64") == 24 * 10 + 2 * 40 + 2 * 8


def test_only_the_constraints_held_count():
    # ragged: 3 problems holding 5 + 7 + 1 constraints, whatever the padding
    assert peaks.kernel_bytes(3, 13, "float32") == 12 * 13 + 24 * 3


def test_roofline_share():
    # 3.35 GB in 1 ms is 100% of 3.35 TB/s; in 4 ms, 25%
    assert peaks.roofline_share(3.35e9, 1.0) == pytest.approx(0.1)
    assert peaks.roofline_share(3.35e9, 1e-3) == pytest.approx(100.0)
    assert peaks.roofline_share(3.35e9, 4e-3) == pytest.approx(25.0)
