"""The ops of the port's Gibbs slice against the JAX package's XLA path.

Each case feeds the same float64 inputs, made from a numpy seed, to the
JAX function (``use_pallas=False``; the conftest pins JAX to the CPU with
x64) and to its counterpart in ``bipk_tpu_torch`` on the CPU, where the
log-determinant kernel's wrapper computes its plain version. The
arithmetic is the same up to summation order: rtol 1e-10. Uniforms are
drawn from the JAX key exactly as the JAX package draws them and handed
to the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from bipk_tpu.algorithms.gibbs import summed_reference_stats as jsummed
from bipk_tpu.models import vehicle as jveh
from bipk_tpu.ops import gaussian as jgauss
from bipk_tpu.ops import mniw as jmniw
from bipk_tpu.ops import resampling as jres
from bipk_tpu_torch import convert
from bipk_tpu_torch.algorithms.gibbs import summed_reference_stats
from bipk_tpu_torch.models import vehicle as tveh
from bipk_tpu_torch.ops import cuda_kernels as ck
from bipk_tpu_torch.ops import gaussian as tgauss
from bipk_tpu_torch.ops import mniw as tmniw
from bipk_tpu_torch.ops import resampling as tres

RTOL = 1e-10
SHAPES = [(20, 1), (5, 2), (40, 1), (41, 1)]  # the tiled widths and the cs widths
N = 64


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


def _packed_stats(rng, m, n, N, steps=60):
    """Packed statistics of ``steps`` rank-1 updates at lam = 1 (numpy)."""
    phi = rng.standard_normal((steps, m, N)) * np.linspace(0.2, 2.0, m)[:, None]
    y = rng.standard_normal((steps, n, N)) + 0.3 * phi[:, :n]
    st = (np.einsum("tin,tcn->icn", phi, y), np.einsum("tin,tjn->ijn", phi, phi),
          np.einsum("tan,tbn->abn", y, y), np.full(N, float(steps)))
    return np.asarray(jmniw.pack_stats_bl(jmniw.MNIW(*map(jnp.asarray, st))))


def _prior_eff(rng, m, n):
    """A proper prior plus a reference-future offset (the summed
    statistics of 30 data), as the cSMC ancestor weights build it."""
    w = rng.standard_normal((m, m + 2))
    prior = tveh.natural_from_standard(
        rng.standard_normal((n, m)), w @ w.T / (m + 2) + 0.5 * np.eye(m),
        1.7 * np.eye(n), 3.0,
    )
    phi = rng.standard_normal((m, 30))
    y = rng.standard_normal((n, 30))
    ref = (phi @ y.T, phi @ phi.T, y @ y.T, 30.0)
    return tuple(np.asarray(p) + r for p, r in zip(prior, ref))


@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("with_prior", [True, False])
def test_log_base_measure_packed_matches_jax(m, n, with_prior):
    rng = np.random.default_rng(10 * m + n)
    S = _packed_stats(rng, m, n, N)
    pe = _prior_eff(rng, m, n) if with_prior else None
    want = jmniw.log_base_measure_packed_bl(
        jnp.asarray(S), jmniw.MNIW(*map(jnp.asarray, pe)) if with_prior else None,
        m, n, use_pallas=False,
    )
    got = tmniw.log_base_measure_packed_bl(
        _t(S), tmniw.MNIW(*map(_t, pe)) if with_prior else None, m, n,
    )
    _close(got, want)


@pytest.mark.parametrize("m,n", SHAPES)
def test_log_base_measure_packed_logdets_plain_matches_jax(m, n):
    """The kernel's plain version against the JAX XLA factorization of
    the same MNIW (``factorize_project_packed_bl`` at lam = 1 shares the
    Pallas kernel's core); the wrapper's CPU branch is the plain version."""
    rng = np.random.default_rng(20 * m + n)
    S = _packed_stats(rng, m, n, N)
    pe = _prior_eff(rng, m, n)
    want = jmniw.factorize_project_packed_bl(
        jnp.asarray(S), jnp.asarray(rng.standard_normal((m, N))),
        prior=jmniw.MNIW(*map(jnp.asarray, pe)), lam=1.0, m=m, n=n,
        use_pallas=False,
    )
    blocks = tuple(map(_t, pe[:3]))
    plain = ck.log_base_measure_packed_logdets_plain(_t(S), 0.0, blocks, m, n)
    wrapped = ck.log_base_measure_packed_logdets(_t(S), 0.0, blocks, m=m, n=n)
    for got in (plain, wrapped):
        _close(got[0], want.logdet_T1)
        _close(got[1], want.logdet_Psi)
    # with the f32 default jitter the diagonal gains jitter * trace / m
    jit = tmniw._default_jitter(torch.float32)
    bumped = ck.log_base_measure_packed_logdets_plain(_t(S), jit, blocks, m, n)
    T1 = tmniw.from_flat_bl(tmniw.unpack_stats_bl(_t(S), m, n), m, n).T1 + blocks[1][..., None]
    bump = jit * torch.diagonal(T1, 0, 0, 1).sum(-1) / m
    L = torch.linalg.cholesky(T1.permute(2, 0, 1) + bump[:, None, None] * torch.eye(m, dtype=T1.dtype))
    _close(bumped[0], 2 * torch.log(torch.diagonal(L, 0, 1, 2)).sum(-1))


@pytest.mark.parametrize("m,n", SHAPES)
def test_log_base_measure_bl_and_from_projected_match_jax(m, n):
    rng = np.random.default_rng(30 * m + n)
    S = _packed_stats(rng, m, n, N)
    pe = _prior_eff(rng, m, n)
    nat = jmniw.from_flat_bl(jmniw.unpack_stats_bl(jnp.asarray(S), m, n), m, n)
    nat = jmniw.MNIW(*(a + jnp.asarray(p)[..., None] if a.ndim > 1 else a + p
                       for a, p in zip(nat, pe)))
    want = jmniw.log_base_measure_bl(nat, use_pallas=False)
    _close(tmniw.log_base_measure_bl(tmniw.MNIW(*map(_t, nat))), want)
    flat = jmniw.to_flat_bl(nat)
    _close(tmniw.log_base_measure_bl(tmniw.MNIW(*map(_t, flat)), m=m, n=n), want)

    fp = jmniw.factorize_project_packed_bl(
        jnp.asarray(S), jnp.asarray(rng.standard_normal((m, N))),
        prior=jmniw.MNIW(*map(jnp.asarray, pe)), lam=1.0, m=m, n=n,
        use_pallas=False,
    )
    want_fp = jmniw.log_base_measure_from_projected_bl(fp, m)
    got_fp = tmniw.log_base_measure_from_projected_bl(tmniw.ProjectedFactor(*map(_t, fp)), m)
    _close(got_fp, want_fp)
    _close(got_fp, want)  # the same MNIW, factored once


@pytest.mark.parametrize("n", [1, 2, 3])
def test_multigammaln_matches_scipy(n):
    a = np.linspace(1.6, 900.0, 50)
    _close(tmniw.multigammaln(_t(a), n), scipy.special.multigammaln(a, n))


@pytest.mark.parametrize("m,n", SHAPES)
def test_suff_stat_and_pack_suff_col_match_jax(m, n):
    rng = np.random.default_rng(m * n)
    y, phi = rng.standard_normal(n), rng.standard_normal(m)
    for g, w in zip(tmniw.suff_stat(_t(y), _t(phi)), jmniw.suff_stat(jnp.asarray(y), jnp.asarray(phi))):
        _close(g, w)
    _close(tmniw.pack_suff_col(_t(y), _t(phi)), jmniw.pack_suff_col(jnp.asarray(y), jnp.asarray(phi)))


def test_categorical_and_ess_match_jax():
    rng = np.random.default_rng(5)
    for trial in range(20):
        key = jax.random.key(trial)
        lw = 3.0 * rng.standard_normal(N)
        if trial % 5 == 0:
            lw[rng.random(N) < 0.9] = -np.inf  # most of the mass on a few
        w = np.asarray(jax.nn.softmax(jnp.asarray(lw)))
        want = int(jres.categorical_from_weights(key, jnp.asarray(w)))
        u = _t(jax.random.uniform(key, dtype=jnp.float64))
        got = tres.categorical_from_weights(_t(w), u)
        assert got.dim() == 0 and int(got) == want
        _close(tres.effective_sample_size(_t(lw)), jres.effective_sample_size(jnp.asarray(lw)))


def test_reconstruct_trajectory_matches_jax():
    rng = np.random.default_rng(6)
    T, dx = 12, 3
    ancestry = np.sort(rng.integers(0, N, (T - 1, N)), axis=1).astype(np.int32)
    final = 17
    states = rng.standard_normal((T, N, dx))
    ivs = (rng.standard_normal((T, N, 1)), rng.standard_normal((T, N, 2)))
    want, want_idx = jres.reconstruct_trajectory(
        (jnp.asarray(states), tuple(map(jnp.asarray, ivs))), jnp.asarray(ancestry), final
    )
    got, got_idx = tres.reconstruct_trajectory(
        (_t(states), tuple(map(_t, ivs))), torch.as_tensor(ancestry), torch.tensor(final)
    )
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        _close(g, w)
    # batch-last traces (T, d, N) give the same trajectories
    got_bl, idx_bl = tres.reconstruct_trajectory_bl(
        (_t(states).transpose(1, 2), tuple(_t(v).transpose(1, 2) for v in ivs)),
        torch.as_tensor(ancestry), torch.tensor(final),
    )
    want_bl, _ = jres.reconstruct_trajectory_bl(
        (jnp.asarray(states).transpose(0, 2, 1),
         tuple(jnp.asarray(v).transpose(0, 2, 1) for v in ivs)),
        jnp.asarray(ancestry), final,
    )
    np.testing.assert_array_equal(idx_bl.numpy(), np.asarray(want_idx))
    for g, w in zip((got_bl[0], *got_bl[1]), (want_bl[0], *want_bl[1])):
        _close(g, w)


def test_mvn_logpdf_chol_matches_jax():
    rng = np.random.default_rng(7)
    d = 3
    W = rng.standard_normal((d, d + 2))
    L = np.linalg.cholesky(W @ W.T + 0.1 * np.eye(d))
    x, mean = rng.standard_normal(d), rng.standard_normal(d)
    _close(tgauss.mvn_logpdf_chol(_t(x), _t(mean), _t(L)),
           jgauss.mvn_logpdf_chol(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(L)))
    X, M = rng.standard_normal((d, N)), rng.standard_normal((d, N))
    want = jax.vmap(jgauss.mvn_logpdf_chol, in_axes=(1, 1, None))(
        jnp.asarray(X), jnp.asarray(M), jnp.asarray(L))
    _close(tgauss.mvn_logpdf_chol(_t(X), _t(M), _t(L)), want)


def test_summed_reference_stats_matches_jax():
    cfg = jveh.VehicleConfig(t_end=40 * 0.02)
    jmodel = jveh.make_model(cfg)
    tmodel = convert.vehicle_model_from_arrays(dataclasses.asdict(cfg), convert.vehicle_arrays(jmodel))
    rng = np.random.default_rng(8)
    T = cfg.n_steps
    ref_state = 0.05 * rng.standard_normal((T, 2))
    ref_iv = (rng.uniform(-0.8, 0.8, (T, 1)), rng.uniform(-0.8, 0.8, (T, 1)))
    inputs = jveh.steering_profile(cfg)
    want = jsummed(jmodel.gps, jnp.asarray(ref_state), tuple(map(jnp.asarray, ref_iv)),
                   jnp.asarray(inputs), jnp.float64)
    got = summed_reference_stats(tmodel.gps, _t(ref_state), tuple(map(_t, ref_iv)),
                                 _t(inputs), torch.float64)
    for g_st, w_st in zip(got, want):
        for g, w in zip(g_st, w_st):
            _close(g, w)
