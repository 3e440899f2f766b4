"""The port's convergence diagnostics (``bipk_tpu_torch.utils.diagnostics``)
against the JAX package's (``bipk_tpu/utils/diagnostics.py``, plain
``jax.numpy`` on the CPU in float64) on the same seeded numpy draws, to
rtol 1e-12: the draws of ``tests/test_chains.py``'s diagnostics tests
(iid, a mean shift, a within-chain trend, heavy tails and a scale
difference, AR(1), vector quantities), and its two Gibbs-summary cases (a
run too short to diagnose, and stuck chains beside moving ones).
"""

import numpy as np
import pytest
import torch

from bipk_tpu.utils import diagnostics as jdiag
from bipk_tpu_torch.utils import diagnostics as tdiag

RTOL = 1e-12


def _ar1(rng, a=0.9, n=20000, c=4):
    x = np.empty((c, n))
    for ci in range(c):
        e = rng.normal(size=n) * np.sqrt(1 - a * a)
        z = np.empty(n)
        z[0] = rng.normal()
        for t in range(1, n):
            z[t] = a * z[t - 1] + e[t]
        x[ci] = z
    return x


def _shifted(rng):
    draws = rng.normal(size=(4, 500))
    draws[0] += 3.0
    return draws


def _scaled_cauchy(rng):
    draws = rng.standard_cauchy(size=(4, 800))
    draws[0] *= 20.0
    return draws


# the draws of tests/test_chains.py's diagnostics tests, by their seeds
CASES = {
    "iid": lambda: np.random.default_rng(0).normal(size=(4, 500)),
    "mean_shift": lambda: _shifted(np.random.default_rng(1)),
    "trend": lambda: (np.random.default_rng(2).normal(size=(4, 500))
                      + np.linspace(-3, 3, 500)),
    "heavy_tails": lambda: np.random.default_rng(3).standard_cauchy(size=(4, 800)),
    "heavy_tails_scaled": lambda: _scaled_cauchy(np.random.default_rng(3)),
    "ess_iid": lambda: np.random.default_rng(4).normal(size=(4, 1000)),
    "ar1": lambda: _ar1(np.random.default_rng(5)),
    "vector": lambda: np.random.default_rng(6).normal(size=(4, 200, 3)),
}
FUNCTIONS = {
    "split_rhat": lambda d, diag: diag.split_rhat(d),
    "rank_normalized_rhat": lambda d, diag: diag.rank_normalized_rhat(d),
    "rank_normalized_rhat_folded": lambda d, diag: diag.rank_normalized_rhat(d, folded=True),
    "rhat": lambda d, diag: diag.rhat(d),
    "ess_mean": lambda d, diag: diag.ess_mean(d),
}


@pytest.mark.parametrize("fn", FUNCTIONS)
@pytest.mark.parametrize("case", CASES)
def test_diagnostics_match_jax(case, fn):
    """Each function on each case: the port's value (a float64 CPU
    tensor of the trailing shape) against the JAX package's, from numpy
    draws and from the same draws as a torch tensor."""
    draws = CASES[case]()
    want = np.asarray(FUNCTIONS[fn](draws, jdiag), dtype=np.float64)
    for given in (draws, torch.as_tensor(draws)):
        got = FUNCTIONS[fn](given, tdiag)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


def test_split_matches_jax():
    """The halving itself: (C, K, ...) -> (2C, K // 2, ...), an odd K's
    last draw dropped."""
    draws = np.random.default_rng(9).normal(size=(3, 11, 2))
    got = tdiag._split(draws)
    assert tuple(got.shape) == (6, 5, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdiag._split(draws)))


def test_split_rhat_refuses_too_few_draws():
    with pytest.raises(ValueError, match="at least 4 draws"):
        tdiag.split_rhat(np.zeros((2, 3)))


def _summaries_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["n_draws"] == w["n_draws"] and g["stuck"] == w["stuck"]
        for k in ("rhat", "ess"):
            if np.isnan(w[k]):
                assert np.isnan(g[k]), (k, g, w)
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=0)


@pytest.mark.parametrize("case", ["too_short", "stuck_and_moving", "moving"])
def test_gibbs_chain_summary_matches_jax(case):
    """``gibbs_chain_summary`` on interface-variable traces ``(C, T, K,
    n_i)``: a run too short to diagnose (NaN R-hat and ESS), stuck chains
    beside moving ones (the stuck flag, NaNs), and moving chains alone
    (finite values); numpy and torch input alike."""
    if case == "too_short":
        int_vars, n_burn = (np.random.default_rng(8).normal(size=(2, 10, 4, 1)),), 2
    else:
        moving = np.random.default_rng(7).normal(size=(3, 10, 8, 1))
        stuck = np.full((3, 10, 8, 1), 0.5)
        int_vars, n_burn = ((moving, stuck) if case == "stuck_and_moving" else (moving,)), 2
    want = jdiag.gibbs_chain_summary(int_vars, n_burn)
    for given in (int_vars, tuple(torch.as_tensor(v) for v in int_vars)):
        _summaries_equal(tdiag.gibbs_chain_summary(given, n_burn), want)
    if case == "moving":
        assert np.isfinite(want[0]["rhat"]) and not want[0]["stuck"]
