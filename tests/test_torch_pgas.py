"""The port's classic PGAS (``bipk_tpu_torch.algorithms.pgas``) and its
parameter draw against the JAX package, on the CPU in float64.

With the JAX package's draws replicated from its key splits and injected
(``mniw.py:286-298``: Bartlett chi-squares, strict-lower normals,
coefficient normals; ``pgas.py:68-134``: the initial normals, then per
step the resampling offset, the reference ancestor's uniform and the
state normals, and the final index's uniform; ``pgas.py:171-199``: the
parameter key, then a sweep key and a parameter key per iteration),
``sample_parameters``, one cSMC sweep and a few PGAS iterations agree to
rtol 1e-10. Then the port's own sweeps (its generator's draws) against an
exact Kalman/RTS smoother (``tests/test_invariance.py``'s configuration
and tolerances) and on the AR(1) posterior (``tests/test_pgas.py``'s
checks), and the generator-driven chi-square draws against
``scipy.stats.chi2``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from bipk_tpu.algorithms.pgas import build_pgas as jbuild_pgas
from bipk_tpu.algorithms.pgas import build_pgas_csmc as jbuild_csmc
from bipk_tpu.ops import basis as jbasis
from bipk_tpu.ops import gaussian as jgauss
from bipk_tpu.ops import mniw as jmniw
from bipk_tpu_torch import algorithms
from bipk_tpu_torch.algorithms.pgas import PGASDraws, build_pgas, build_pgas_csmc
from bipk_tpu_torch.ops import basis as tbasis
from bipk_tpu_torch.ops import gaussian as tgauss
from bipk_tpu_torch.ops import mniw as tmniw

F64 = jnp.float64


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


def _close(got, want, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _ar1_data(key, a, q, r, T):
    """``tests/test_invariance.py``'s AR(1) simulation."""
    def step(x, k):
        kw, kv = jax.random.split(k)
        xn = a * x + q * jax.random.normal(kw, (1,), F64)
        y = xn + r * jax.random.normal(kv, (1,), F64)
        return xn, (xn, y)

    keys = jax.random.split(key, T - 1)
    x0 = jnp.zeros((1,), dtype=F64)
    _, (xs, ys) = jax.lax.scan(step, x0, keys)
    return (np.asarray(jnp.concatenate([x0[None], xs])),
            np.asarray(jnp.concatenate([jnp.zeros((1, 1), dtype=F64), ys])))


def _param_draws(key, df, n, m):
    """The draws of ``bipk_tpu.ops.mniw.sample_parameters(key, nat)`` for
    an MNIW with ``n`` outputs, ``m`` basis functions and ``df``."""
    key_bartlett, key_normals, key_coeff = jax.random.split(key, 3)
    dof = df - jnp.arange(n, dtype=F64)
    return tmniw.ParameterDraws(
        _t(jax.random.chisquare(key_bartlett, dof, dtype=F64)),
        _t(jax.random.normal(key_normals, (n, n), dtype=F64)),
        _t(jax.random.normal(key_coeff, (n, m), dtype=F64)),
    )


def _sweep_draws(key, T, N, dx):
    """The draws of one ``build_pgas_csmc`` sweep with ``key``
    (``pgas.py:68-134``), batch-last."""
    key, key_init = jax.random.split(key)
    z0 = jax.random.normal(key_init, (N, dx), dtype=F64)
    keys = jax.random.split(key, T)
    u_res, u_ref, z = [], [], []
    for k in keys[:-1]:
        k, key_res = jax.random.split(k)
        k, key_ref = jax.random.split(k)
        k, key_state = jax.random.split(k)
        u_res.append(jax.random.uniform(key_res, dtype=F64))
        u_ref.append(jax.random.uniform(key_ref, dtype=F64))
        z.append(jax.random.normal(key_state, (N, dx), dtype=F64).T)
    return PGASDraws(_t(z0).T, _t(u_res), _t(u_ref),
                     _t(jax.random.uniform(keys[-1], dtype=F64)).reshape(1), _t(np.stack(z)))


def _random_mniw(rng, m, n, n_data):
    """A proper MNIW posterior: a prior plus ``n_data`` random data."""
    prior = tmniw.natural_from_standard(
        rng.standard_normal((n, m)), np.eye(m) * 2.0 + 0.1, np.eye(n) * 0.5, 3.0)
    phi = rng.standard_normal((m, n_data))
    y = rng.standard_normal((n, n_data))
    return tmniw.MNIW(prior.T0 + phi @ y.T, prior.T1 + phi @ phi.T, prior.T2 + y @ y.T,
                      prior.T3 + n_data)


@pytest.mark.parametrize("m,n", [(9, 1), (4, 2)])
def test_sample_parameters_matches_jax(m, n):
    nat = _random_mniw(np.random.default_rng(m), m, n, 30)
    key = jax.random.key(11 + m)
    want_A, want_S = jmniw.sample_parameters(key, jmniw.MNIW(*(jnp.asarray(p) for p in nat)))
    draws = _param_draws(key, float(nat.T3), n, m)
    got_A, got_S = tmniw.sample_parameters(tmniw.MNIW(*(_t(p) for p in nat)), draws)
    assert got_A.shape == (n, m) and got_S.shape == (n, n)
    _close(got_A, want_A)
    _close(got_S, want_S)


def test_mvn_helpers_match_jax():
    """``mvn_logpdf`` (factorizing the covariance) and ``mvn_sample_chol``
    (the normals as an input, batch-last) against the JAX package's."""
    rng = np.random.default_rng(5)
    B = rng.standard_normal((3, 3))
    cov, mean = B @ B.T + np.eye(3), rng.standard_normal(3)
    x = rng.standard_normal((3, 7))
    want = jax.vmap(lambda xi: jgauss.mvn_logpdf(xi, mean, cov))(jnp.asarray(x.T))
    _close(tgauss.mvn_logpdf(_t(x), _t(mean)[:, None], _t(cov)), want)
    key = jax.random.key(3)
    chol = np.linalg.cholesky(cov)
    want = jgauss.mvn_sample_chol(key, jnp.asarray(mean), jnp.asarray(chol), (7,))
    z = jax.random.normal(key, (7, 3), dtype=F64)
    _close(tgauss.mvn_sample_chol(_t(mean), _t(chol), _t(z).T), np.asarray(want).T)


def _ar1_fns(r_obs):
    """The AR(1) basis and likelihood, JAX (per particle) and port
    (batch-last)."""
    jfns = (lambda x, u: x,
            lambda obs, x, u: jnp.squeeze(-0.5 * ((obs[0] - x[0]) / r_obs) ** 2))
    tfns = (lambda x, u: x, lambda obs, x, u: -0.5 * ((obs[0] - x[0]) / r_obs) ** 2)
    return jfns, tfns


def _osc2d():
    """A 2-D state whose transition is a 6-function Hilbert basis over the
    state (``A (2, 6)``), its first component observed; simulated data."""
    jhb = jbasis.make_hilbert_basis(6, np.array([[-3.0, 3.0]] * 2), 1.5, 2.0)
    thb = tbasis.make_hilbert_basis(6, np.array([[-3.0, 3.0]] * 2), 1.5, 2.0)
    rng = np.random.default_rng(3)
    A = 0.8 * rng.standard_normal((2, 6))
    S = np.array([[0.05, 0.01], [0.01, 0.03]])
    T, r_obs = 20, 0.2
    x = np.zeros((T, 2))
    x[0] = [0.3, -0.2]
    for t in range(1, T):
        x[t] = A @ thb.eigen_fn_bl(_t(x[t - 1])[:, None])[:, 0].numpy() \
            + np.linalg.cholesky(S) @ rng.standard_normal(2)
    y = np.concatenate([np.zeros((1, 1)), x[1:, :1] + r_obs * rng.standard_normal((T - 1, 1))])
    jfns = (lambda xx, u: jhb.eigen_fn(xx),
            lambda obs, xx, u: jnp.squeeze(-0.5 * ((obs[0] - xx[0]) / r_obs) ** 2))
    tfns = (lambda xx, u: thb.eigen_fn_bl(xx),
            lambda obs, xx, u: -0.5 * ((obs[0] - xx[0]) / r_obs) ** 2)
    return jfns, tfns, A, S, x, y


@pytest.mark.parametrize("model", ["ar1", "2d"])
def test_one_csmc_sweep_matches_jax(model):
    N, T = 16, 20
    if model == "ar1":
        a, q = 0.85, 0.3
        jfns, tfns = _ar1_fns(0.4)
        X, Y = _ar1_data(jax.random.key(1), a, q, 0.4, T)
        A, S = np.array([[a]]), np.array([[q * q]])
        init_mean, init_cov = np.zeros(1), np.eye(1) * 1e-2
    else:
        jfns, tfns, A, S, X, Y = _osc2d()
        init_mean, init_cov = X[0], np.diag([1e-2, 2e-2])
    U = np.zeros((T, 0))
    key = jax.random.key(5)
    # a reference that is not the simulated trajectory
    ref = X + 0.05 * np.random.default_rng(0).standard_normal(X.shape)
    want = jax.jit(jbuild_csmc(*jfns, N, dtype=F64))(
        key, jnp.asarray(Y), jnp.asarray(U), init_mean, init_cov, jnp.asarray(ref),
        jnp.asarray(A), jnp.asarray(S))
    csmc = build_pgas_csmc(*tfns, N, dtype=torch.float64, device="cpu")
    got = csmc.run(_sweep_draws(key, T, N, X.shape[1]), Y, U, init_mean, init_cov, ref, A, S)
    assert got.shape == X.shape
    _close(got, want)
    assert not np.allclose(np.asarray(want), ref)  # the sweep moved the trajectory


def test_pgas_iterations_match_jax():
    a, q, r_obs, T, N, K = 0.85, 0.3, 0.1, 20, 16, 4
    X, Y = _ar1_data(jax.random.key(7), a, q, r_obs, T)
    prior = jmniw.natural_from_standard(np.zeros((1, 1)), np.eye(1) * 10.0, np.eye(1) * 0.1, 3.0)
    jfns, tfns = _ar1_fns(r_obs)
    U = np.zeros((T, 0))
    init_mean, init_cov = np.zeros(1), np.eye(1) * 1e-2
    key = jax.random.key(9)
    want = jax.jit(jbuild_pgas(*jfns, prior, N, K, dtype=F64))(
        key, jnp.asarray(Y), jnp.asarray(U), init_mean, init_cov, jnp.asarray(X))

    df = float(prior.T3) + T - 1
    key, key_params = jax.random.split(key)
    draws = [(None, _param_draws(key_params, df, 1, 1))]
    for k in jax.random.split(key, K - 1):
        key_sweep, key_params = jax.random.split(k)
        draws.append((_sweep_draws(key_sweep, T, N, 1), _param_draws(key_params, df, 1, 1)))
    pgas = build_pgas(*tfns, tmniw.MNIW(*(np.asarray(p) for p in prior)), N, K,
                      dtype=torch.float64, device="cpu")
    got = pgas.run(draws, Y, U, init_mean, init_cov, X)
    assert got.states.shape == (T, K, 1) and got.coeffs.shape == (K, 1, 1)
    for name in ("states", "log_likelihood", "coeffs", "covs"):
        _close(getattr(got, name), getattr(want, name))


def _rts(y, a, q2, r2, p0):
    """Kalman filter + RTS smoother; no observation at t=0 (matching the
    samplers, whose weighting starts at t=1)."""
    T = len(y)
    mf, pf = np.zeros(T), np.zeros(T)
    m, p = 0.0, p0
    mf[0], pf[0] = m, p
    for t in range(1, T):
        m, p = a * m, a * a * p + q2
        k = p / (p + r2)
        m, p = m + k * (y[t] - m), (1 - k) * p
        mf[t], pf[t] = m, p
    ms, ps = mf.copy(), pf.copy()
    for t in range(T - 2, -1, -1):
        pp = a * a * pf[t] + q2
        g = a * pf[t] / pp
        ms[t] = mf[t] + g * (ms[t + 1] - a * mf[t])
        ps[t] = pf[t] + g * g * (ps[t + 1] - pp)
    return ms, ps


@pytest.mark.parametrize("r_obs", [0.05, 0.4])
def test_csmc_invariance_vs_rts(r_obs):
    """``tests/test_invariance.py`` on the port: repeated sweeps of the
    fixed-parameter cSMC (the port's own draws) pool to the exact
    smoothing posterior's moments, with that test's tolerances."""
    a, q, T, p0 = 0.85, 0.3, 50, 1e-2
    key = jax.random.key(7)
    key, key_sim = jax.random.split(key)
    X, Y = _ar1_data(key_sim, a, q, r_obs, T)
    ms, ps = _rts(Y[:, 0], a, q * q, r_obs * r_obs, p0)

    _, tfns = _ar1_fns(r_obs)
    sweep = build_pgas_csmc(*tfns, 64, dtype=torch.float64, device="cpu")
    A, S = torch.tensor([[a]], dtype=torch.float64), torch.tensor([[q * q]], dtype=torch.float64)
    inputs = torch.zeros((T, 0), dtype=torch.float64)
    Yt = _t(Y)
    g = torch.Generator().manual_seed(7)
    ref = _t(X)
    burn, keep = 60, 240
    trajs = []
    for k in range(burn + keep):
        ref = sweep(g, Yt, inputs, np.zeros(1), np.eye(1) * p0, ref, A, S)
        if k >= burn:
            trajs.append(ref.numpy())
    trajs = np.stack(trajs)[:, :, 0]  # (keep, T)

    emp_mean = trajs.mean(0)
    emp_var = trajs.var(0)
    post_std = np.sqrt(ps)
    assert np.abs(emp_mean - ms).mean() < 0.35 * post_std.mean(), (
        np.abs(emp_mean - ms).mean(), post_std.mean())
    ratio = emp_var[5:] / ps[5:]
    assert 0.6 < ratio.mean() < 1.4, ratio.mean()


@pytest.fixture(scope="module")
def pgas_ar1():
    """``tests/test_pgas.py``'s configuration on the port (its own
    draws): PGAS with the linear basis learns the AR coefficient."""
    a_true, q_true, r_obs, T = 0.85, 0.3, 0.1, 120
    key = jax.random.key(7)
    key, key_sim = jax.random.split(key)
    X, Y = _ar1_data(key_sim, a_true, q_true, r_obs, T)
    prior = tmniw.natural_from_standard(np.zeros((1, 1)), np.eye(1) * 10.0, np.eye(1) * 0.1, 3.0)
    run = algorithms.build_pgas(
        basis_fn=lambda x, u: x,
        likelihood_fn=lambda obs, x, u: (-0.5 * ((obs[0] - x[0]) / r_obs) ** 2
                                         - np.log(r_obs) - 0.5 * np.log(2 * np.pi)),
        prior=prior, n_particles=80, n_iterations=200, dtype=torch.float64, device="cpu",
    )
    res = run(torch.Generator().manual_seed(7), Y, np.zeros((T, 0)), np.zeros(1),
              np.eye(1) * 1e-2, X)
    return a_true, q_true, X, res


def test_pgas_shapes(pgas_ar1):
    _, _, X, res = pgas_ar1
    T = X.shape[0]
    assert res.states.shape == (T, 200, 1)
    assert res.coeffs.shape == (200, 1, 1)
    assert res.covs.shape == (200, 1, 1)
    assert res.log_likelihood.shape == (T, 200)
    assert bool(torch.isfinite(res.log_likelihood).all())


def test_pgas_ar_coefficient_posterior(pgas_ar1):
    _, _, X, res = pgas_ar1
    xn = X[:, 0]
    ls = np.sum(xn[1:] * xn[:-1]) / np.sum(xn[:-1] ** 2)
    a_draws = res.coeffs[100:, 0, 0].numpy()
    assert abs(a_draws.mean() - ls) < 0.08, (a_draws.mean(), ls)


def test_pgas_noise_posterior(pgas_ar1):
    _, q_true, _, res = pgas_ar1
    s_draws = res.covs[100:, 0, 0].numpy()
    assert abs(np.median(s_draws) - q_true**2) < 0.05, np.median(s_draws)


def test_pgas_chain_moves(pgas_ar1):
    _, _, _, res = pgas_ar1
    diffs = np.abs(np.diff(res.states[:, :, 0].numpy(), axis=1)).mean(0)
    assert np.all(diffs > 1e-4)


@pytest.mark.parametrize("dof", [1.0, 2.0, 2401.0])
def test_chisquare_draws_follow_scipy(dof):
    """The generator-driven chi-square draws (Marsaglia-Tsang, boosted
    below shape 1) against ``scipy.stats.chi2``, Kolmogorov-Smirnov."""
    g = torch.Generator().manual_seed(int(dof))
    x = tmniw.draw_chisquare(g, torch.full((4000,), dof, dtype=torch.float64)).numpy()
    assert np.all(np.isfinite(x)) and np.all(x > 0)
    p = scipy.stats.kstest(x, scipy.stats.chi2(dof).cdf).pvalue
    assert p > 1e-3, p


def test_chisquare_raises_when_every_candidate_is_rejected():
    K = tmniw.GAMMA_ATTEMPTS
    dof = torch.tensor([4.0, 4.0], dtype=torch.float64)
    z = torch.full((K, 2), -100.0, dtype=torch.float64)  # 1 + c z < 0: v <= 0
    z[3, 0] = 0.0  # one candidate of the first entry is accepted
    u = torch.full((K, 2), 0.5, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="rejected"):
        tmniw.chisquare(dof, z, u, torch.ones(2, dtype=torch.float64))
    z[5, 1] = 0.0
    got = tmniw.chisquare(dof, z, u, torch.ones(2, dtype=torch.float64))
    _close(got, [2.0 * (2.0 - 1.0 / 3.0)] * 2)  # d v at z = 0
