"""The port's rank-1 Cholesky maintenance (``bipk_tpu_torch.ops.cholup``)
against the JAX package's (``bipk_tpu.ops.cholup``), the counterparts of
the checks in ``tests/test_cholup.py``.

The same float64 inputs, made with numpy from a seed, go through both; the
port computes the same arithmetic per element (a column's entries as one
tensor op per term), so the tolerance is rtol 1e-10, and the exactness
checks against a refactorization keep ``tests/test_cholup.py``'s bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipk_tpu.ops import batched_linalg as jbla
from bipk_tpu.ops import cholup as jcholup
from bipk_tpu.ops import mniw as jmniw
from bipk_tpu_torch.ops import cholup as tcholup
from bipk_tpu_torch.ops import mniw as tmniw

RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes; one intra-op thread per
    worker keeps the torch side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, want, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _spd_stack(rng, p, N):
    X = rng.standard_normal((p, 3 * p, N))
    return np.einsum("ikn,jkn->ijn", X, X)


def _chol(A):
    return np.asarray(jbla.chol_lower_bl(jnp.asarray(A)))


def _random_mniw_bl(rng, m, n, N):
    T0 = rng.standard_normal((m, n, N))
    T1 = _spd_stack(rng, m, N)
    T2 = _spd_stack(rng, n, N) + 3.0 * np.eye(n)[:, :, None]
    T3 = np.abs(rng.standard_normal(N)) + n + 4.0
    return T0, T1, T2, T3


def test_rank1_update_matches_jax_and_refactorization():
    rng = np.random.default_rng(0)
    p, N = 9, 37
    A = _spd_stack(rng, p, N)
    L = _chol(A)
    x = rng.standard_normal((p, N))
    got = tcholup.chol_rank1_update_bl(_t(L), _t(x))
    _close(got, jcholup.chol_rank1_update_bl(jnp.asarray(L), jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), _chol(A + x[:, None] * x[None]), atol=1e-12)


def test_rank1_downdate_matches_jax_and_inverts_update():
    rng = np.random.default_rng(1)
    p, N = 7, 23
    L = _chol(_spd_stack(rng, p, N))
    x = rng.standard_normal((p, N))
    up = tcholup.chol_rank1_update_bl(_t(L), _t(x))
    got = tcholup.chol_rank1_downdate_bl(up, _t(x))
    _close(got, jcholup.chol_rank1_downdate_bl(jnp.asarray(up.numpy()), jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), L, atol=1e-10)


@pytest.mark.parametrize("fn", ["chol_rank1_update_bl", "chol_rank1_downdate_bl"])
@pytest.mark.parametrize("shape", ["(p,)", "(p, 1)"])
def test_rank1_broadcast_vector_matches_jax(fn, shape):
    """One vector for every particle (the cSMC's reference datum ``z_ref``,
    ``(p, 1)``) broadcasts across the batch: the same as the tiled vector,
    and as JAX's broadcast."""
    rng = np.random.default_rng(2)
    p, N = 5, 16
    L = _chol(_spd_stack(rng, p, N))
    x = 0.3 * rng.standard_normal(p)
    xb = x if shape == "(p,)" else x[:, None]
    got = getattr(tcholup, fn)(_t(L), _t(xb))
    tiled = getattr(tcholup, fn)(_t(L), _t(np.tile(x[:, None], (1, N))))
    _close(got, tiled, rtol=0, atol=0)
    _close(got, getattr(jcholup, fn)(jnp.asarray(L), jnp.asarray(x[:, None])))


def test_aug_factor_views_match_jax_and_factorize():
    m, n, N = 6, 2, 19
    nat = _random_mniw_bl(np.random.default_rng(3), m, n, N)
    F, df = tcholup.aug_factorize_bl(tmniw.MNIW(*map(_t, nat)))
    jF, jdf = jcholup.aug_factorize_bl(jmniw.MNIW(*map(jnp.asarray, nat)))
    _close(F, jF)
    _close(df, jdf)
    fac = tcholup.aug_to_factor(F, df, m)
    for g, w in zip(fac, jcholup.aug_to_factor(jF, jdf, m)):
        _close(g, w)
    ref = jmniw.factorize_bl(jmniw.MNIW(*map(jnp.asarray, nat)), use_pallas=False)
    np.testing.assert_allclose(fac.chol.numpy(), np.asarray(ref.chol), atol=1e-12)
    np.testing.assert_allclose(fac.white_T0.numpy(), np.asarray(ref.white_T0), atol=1e-11)
    np.testing.assert_allclose(fac.row_scale.numpy(), np.asarray(ref.row_scale), atol=1e-10)
    # the views read the factor in place, particle stride 1
    assert fac.chol.data_ptr() == F.data_ptr() and fac.white_T0.stride(-1) == 1


def test_aug_factorize_jitter_matches_jax():
    """The relative jitter on the T1 block, as the f32 sweeps put it."""
    nat = _random_mniw_bl(np.random.default_rng(6), 6, 1, 11)
    F, _ = tcholup.aug_factorize_bl(tmniw.MNIW(*map(_t, nat)), jitter=1e-6)
    jF, _ = jcholup.aug_factorize_bl(jmniw.MNIW(*map(jnp.asarray, nat)), jitter=1e-6)
    _close(F, jF)


def test_aug_log_base_measure_matches_jax_and_direct():
    m, n, N = 6, 2, 19
    nat = _random_mniw_bl(np.random.default_rng(4), m, n, N)
    F, df = tcholup.aug_factorize_bl(tmniw.MNIW(*map(_t, nat)))
    got = tcholup.aug_log_base_measure(F, df, m)
    jF, jdf = jcholup.aug_factorize_bl(jmniw.MNIW(*map(jnp.asarray, nat)))
    _close(got, jcholup.aug_log_base_measure(jF, jdf, m))
    want = jmniw.log_base_measure_bl(jmniw.MNIW(*map(jnp.asarray, nat)), use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9)


def test_log_base_measure_from_factor_matches_jax_and_direct():
    m, n, N = 6, 2, 19
    nat = _random_mniw_bl(np.random.default_rng(5), m, n, N)
    fac = tmniw.factorize_bl(tmniw.MNIW(*map(_t, nat)))
    got = tmniw.log_base_measure_from_factor_bl(fac)
    jfac = jmniw.factorize_bl(jmniw.MNIW(*map(jnp.asarray, nat)), use_pallas=False)
    _close(got, jmniw.log_base_measure_from_factor_bl(jfac))
    want = jmniw.log_base_measure_bl(jmniw.MNIW(*map(jnp.asarray, nat)), use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9)
