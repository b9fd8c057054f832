"""The yardstick's counts against hand-worked shapes."""

import pytest

from benchmark import counts


def test_kernel_a_counts_by_hand():
    # m 2, n 3, s 1, p 1: mixture 4*1*1*2*3 = 24, A and A A^T 2*2*3*3 = 36,
    # A err 2*2*3 = 12; envelope 4*1*2*3 = 24; floats: Linv 3, z 2, x and
    # err 6, parameters 4, A A^T 4, A err 2 = 21
    assert counts.kernel_a(2, 3, 1, 1) == (72, 24, 84)


def test_kernel_b_takes_the_fewer_operation_association():
    m, n, s, p = 2, 3, 1, 1
    tri = m * (m + 1) * n
    again = 2 * tri + 4 * m * m * n + 2 * m * n                           # 96
    folded = (m * m + 3 * m * m * (m + 1) + m * (m + 1) + 2 * m * m * n + 4 * m * n
              + tri + 2 * m ** 3 + m * m)                                 # 108
    assert min(again, folded) == 96
    got = counts.kernel_b(m, n, s, p)
    assert got[0] == 96 + 4 * p * s * m * n + 8 * p * s * m * n
    assert got[1] == 4 * s * m * n
    assert got[2] == 4 * (3 + 2 * 4 + 2 * 2 + 2 * 3 + 2 * 4)
    # at the separation's widths the folded association is the fewer
    m, n = 112, 2001
    tri = m * (m + 1) * n
    folded = (m * m + 3 * m * m * (m + 1) + m * (m + 1) + 2 * m * m * n + 4 * m * n
              + tri + 2 * m ** 3 + m * m)
    assert counts.kernel_b(m, n, 3, 5)[0] == folded + 12 * 5 * 3 * m * n


def test_cholesky_and_specmix_by_hand():
    assert counts.cholesky(3, 4) == (9.0, 3.0, 48)
    assert counts.specmix(2, 3, 1, 1) == (24, 24, 4 * (6 + 2 + 3 + 4))


def test_least_time_is_the_slowest_unit():
    assert counts.least_s((495e12, 0, 0)) == pytest.approx(1.0)
    assert counts.least_s((0, 67e12, 0)) == pytest.approx(1.0)
    assert counts.least_s((495e12, 67e12, 2 * 3.35e12)) == pytest.approx(2.0)


def test_bank_step_and_prediction_scale_with_windows():
    one = counts.bank_step(1, 16, 100, 2, 3)
    assert counts.bank_step(5, 16, 100, 2, 3) == pytest.approx(tuple(5 * c for c in one))
    a, b = counts.kernel_a(16, 100, 2, 3), counts.kernel_b(16, 100, 2, 3)
    assert one[0] > a[0] + b[0] and one[1] >= a[1] + b[1]
    pred = counts.predict_sources(2, 10, 3, 2)
    spec = counts.specmix(10, 10, 3, 2)
    assert pred[0] == pytest.approx(2 * (spec[0] + 1000 / 3 + 3 * 1000 + 2 * 3 * 100 + 400))
    assert pred[2] == 2 * spec[2]
