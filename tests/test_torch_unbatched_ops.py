"""The unbatched public ops against their JAX functions, on the same numpy
inputs from a seed, in float64 to rtol 1e-10: ``mniw.factor_mean_at``,
``sample_predictive`` (given JAX's own Student-t draws),
``log_base_measure``, ``to_batch_last`` / ``from_batch_last``,
``tri_col_offset``; ``batched_linalg``'s ``chol_lower``, ``solve_lower``,
``solve_lower_t``, ``cho_solve``, ``logdet_from_chol``;
``integrators.discretize_rk4``; and ``resampling.systematic_searchsorted``,
exactly on the same ``u``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipk_tpu.ops import batched_linalg as jbla
from bipk_tpu.ops import integrators as jint
from bipk_tpu.ops import mniw as jmniw
from bipk_tpu.ops import resampling as jres
from bipk_tpu.ops.gaussian import student_t as jstudent_t
from bipk_tpu_torch.ops import batched_linalg as bla
from bipk_tpu_torch.ops import integrators
from bipk_tpu_torch.ops import mniw
from bipk_tpu_torch.ops import resampling

RTOL = 1e-10


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * max(1.0, float(np.abs(want).max())))


def _spd(rng, m):
    A = rng.standard_normal((m, m))
    return A @ A.T + m * np.eye(m)


def _nat(rng, m, n):
    """Natural parameters with T1 not symmetric (the ops symmetrize it)."""
    A = rng.standard_normal((m, m))
    return (rng.standard_normal((m, n)), _spd(rng, m) + 0.1 * A, _spd(rng, n) + 10.0 * np.eye(n),
            np.asarray(m + n + 5.0))


def _pair(nat):
    return (jmniw.MNIW(*(jnp.asarray(a) for a in nat)),
            mniw.MNIW(*(torch.as_tensor(a) for a in nat)))


@pytest.mark.parametrize("m,n", [(6, 1), (9, 2), (20, 1), (41, 2)])
def test_factor_mean_at_and_sample_predictive(m, n):
    rng = np.random.default_rng(100 * m + n)
    jnat, tnat = _pair(_nat(rng, m, n))
    jf, tf = jmniw.factorize(jnat), mniw.factorize(tnat)
    phi = rng.standard_normal(m)
    _close(mniw.factor_mean_at(tf, torch.as_tensor(phi)),
           jmniw.factor_mean_at(jf, jnp.asarray(phi)))
    grid = rng.standard_normal((m, 7))  # a grid of basis vectors, one per column
    _close(mniw.factor_mean_at(tf, torch.as_tensor(grid)),
           jax.vmap(lambda p: jmniw.factor_mean_at(jf, p), in_axes=1, out_axes=1)(jnp.asarray(grid)))
    jpred = jmniw.factor_predictive(jf, jnp.asarray(phi))
    tpred = mniw.factor_predictive(tf, torch.as_tensor(phi))
    key = jax.random.key(m + n)
    # JAX's sample_predictive draws t = student_t(key, df, (n,)) and nothing else
    t = jstudent_t(key, jpred.df, (n,), jnp.float64)
    _close(mniw.sample_predictive(tpred, torch.as_tensor(np.asarray(t))),
           jmniw.sample_predictive(key, jpred))


def test_predictive_t_draws_from_a_generator():
    rng = np.random.default_rng(3)
    _, tnat = _pair(_nat(rng, 9, 2))
    pred = mniw.factor_predictive(mniw.factorize(tnat), torch.as_tensor(rng.standard_normal(9)))
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    t = mniw.predictive_t_draws(g, pred)
    assert t.shape == (2,) and t.dtype == torch.float64 and bool(torch.isfinite(t).all())
    g.set_state(state)
    y = mniw.sample_predictive(pred, mniw.predictive_t_draws(g, pred))
    assert torch.equal(y, mniw.sample_predictive(pred, t))


@pytest.mark.parametrize("m,n", [(6, 1), (9, 2), (20, 1), (41, 2)])
def test_log_base_measure(m, n):
    rng = np.random.default_rng(7 * m + n)
    jnat, tnat = _pair(_nat(rng, m, n))
    _close(mniw.log_base_measure(tnat), jmniw.log_base_measure(jnat))


def test_batch_layout_and_packed_offsets():
    rng = np.random.default_rng(5)
    N, m, n = 4, 6, 2
    nat = (rng.standard_normal((N, m, n)), rng.standard_normal((N, m, m)),
           rng.standard_normal((N, n, n)), rng.standard_normal(N))
    jnat, tnat = _pair(nat)
    jbl, tbl = jmniw.to_batch_last(jnat), mniw.to_batch_last(tnat)
    for got, want in zip(tbl, jbl):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for got, want in zip(mniw.from_batch_last(tbl), jmniw.from_batch_last(jbl)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for k, a in enumerate(mniw.from_batch_last(tbl)):
        np.testing.assert_array_equal(np.asarray(a), nat[k])
    for m in (1, 6, 20, 41):
        assert [mniw.tri_col_offset(j, m) for j in range(m)] == \
            [jmniw.tri_col_offset(j, m) for j in range(m)]


@pytest.mark.parametrize("m", [1, 5, 20, 41])
def test_batched_linalg_unbatched(m):
    rng = np.random.default_rng(m)
    A = _spd(rng, m)
    jL, tL = jbla.chol_lower(jnp.asarray(A)), bla.chol_lower(torch.as_tensor(A))
    _close(tL, jL)
    for shape in ((m,), (m, 3)):
        b = rng.standard_normal(shape)
        for name in ("solve_lower", "solve_lower_t", "cho_solve"):
            _close(getattr(bla, name)(tL, torch.as_tensor(b)),
                   getattr(jbla, name)(jL, jnp.asarray(b)))
    _close(bla.logdet_from_chol(tL), jbla.logdet_from_chol(jL))
    # where the factorization fails both give NaN
    bad = -np.eye(m)
    assert np.isnan(np.asarray(jbla.chol_lower(jnp.asarray(bad)))).any()
    assert bool(torch.isnan(bla.chol_lower(torch.as_tensor(bad))).any())


def test_discretize_rk4():
    def rhs(np_mod):
        def f(x, u):
            return np_mod.stack([x[1], -np_mod.sin(x[0]) - 0.3 * x[1] + u])
        return f

    jstep = jint.discretize_rk4(rhs(jnp), 0.05)
    tstep = integrators.discretize_rk4(rhs(torch), 0.05)
    x = np.array([0.4, -0.2])
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    for k in range(20):
        jx, tx = jstep(jx, 0.1 * k), tstep(tx, 0.1 * k)
    _close(tx, jx)


@pytest.mark.parametrize("n", [1, 2, 7, 200, 1025])
def test_systematic_searchsorted_exact(n):
    """The JAX function draws its ``u`` from its key: the port gets the same
    ``u`` and must give the same ancestors, for random, heavy-tailed, zero
    and one-hot weights."""
    rng = np.random.default_rng(n)
    kinds = [rng.uniform(size=n), np.exp(8.0 * rng.standard_normal(n)), np.zeros(n),
             np.eye(n)[0], np.eye(n)[-1]]
    for w in kinds:
        for seed in range(4):
            key = jax.random.key(1000 * n + seed)
            u = float(jax.random.uniform(key, dtype=jnp.float64))
            want = np.asarray(jres.systematic_searchsorted(key, jnp.asarray(w)))
            got = resampling.systematic_searchsorted(torch.as_tensor(w), u)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
        for u in (0.0, 0.999999):  # the grid's ends: sorted ancestors in range
            got = resampling.systematic_searchsorted(torch.as_tensor(w), u)
            assert bool((got[1:] >= got[:-1]).all()) and 0 <= int(got.min()) <= int(got.max()) < n
