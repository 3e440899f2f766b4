"""The cost functions against counts by hand."""

import pytest

from portbench import costs


@pytest.mark.parametrize("m, n, rows", [(20, 1, 232), (41, 1, 904), (20, 2, 254)])
def test_packed_rows(m, n, rows):
    assert costs.packed_rows(m, n) == rows


def test_core_flops_m20():
    # Cholesky sum_c (20 - c)(2c + 1) + 40 = 2910 + 40; two forward
    # substitutions 2 x 400; Schur complement 40, mean 40, col 40, logs 20
    assert costs.particle_flops(20, 1)[0] == 3850


def test_packed_bytes_m20():
    N = 1000
    fp, du, lbm = costs.packed_bytes(20, 1, N)
    prior = 20 + 400 + 1
    assert fp == 4 * (N * (232 + 20 + 1 + 1 + 1 + 2) + prior)
    assert lbm == 4 * (N * (232 + 2) + prior)
    assert costs.packed_bytes(20, 1, N, distinct=10)[1] == 4 * (10 * 232 + N * (232 + 20 + 3 + 2 + 1) + prior)


def test_least_time_bounds():
    """The least time is the larger of the byte and the flop bound."""
    assert costs.least_s(67e12, 0) == pytest.approx(1.0)
    assert costs.least_s(0, 3.35e12) == pytest.approx(1.0)
    one = costs.kernel_least_s("lookahead", 20, 1, 1 << 20)
    assert one == pytest.approx(costs.packed_bytes(20, 1, 1 << 20)[0] / 3.35e12)
    step = costs.step_least_s([(20, 1), (20, 1)], 2, 1 << 20)
    assert step > one
