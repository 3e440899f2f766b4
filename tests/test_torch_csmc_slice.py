"""The port's cSMC sweep and Gibbs sampler (vehicle model) against the JAX
package on one CPU device: a seed-replicated z-test of the sweep, the
pinned reference particle, and the Gibbs result's layout.

Both sweeps run on the same converted model, the same JAX-simulated data
and the same reference (the simulated trajectory and frictions); the RNG
streams differ, so the sweeps agree in distribution, not in value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipk_tpu.algorithms.csmc import build_csmc as jbuild_csmc
from bipk_tpu.algorithms.gibbs import summed_reference_stats as jsummed
from bipk_tpu.models import vehicle as jveh
from bipk_tpu.ops import mniw as jmniw
from bipk_tpu.ops.gaussian import mvn_logpdf_chol as jmvn_logpdf_chol
from bipk_tpu_torch import convert
from bipk_tpu_torch.algorithms.csmc import build_csmc
from bipk_tpu_torch.algorithms.gibbs import build_gibbs

F64 = jnp.float64


@pytest.fixture(scope="module")
def setup():
    cfg = jveh.VehicleConfig(t_end=25 * 0.02)
    jmodel = jveh.make_model(cfg)
    X, Y, mu_f, mu_r, U = jveh.simulate(jax.random.key(5), cfg, dtype=F64)
    tmodel = convert.vehicle_model_from_arrays(dataclasses.asdict(cfg), convert.vehicle_arrays(jmodel))
    ref_state = np.asarray(X)
    ref_ivs = (np.asarray(mu_f)[:, None], np.asarray(mu_r)[:, None])
    summed = jsummed(jmodel.gps, jnp.asarray(ref_state), tuple(map(jnp.asarray, ref_ivs)),
                     jnp.asarray(U), F64)
    summed = [jmniw.MNIW(*(np.asarray(a) for a in st)) for st in summed]
    return jmodel, tmodel, np.asarray(Y), np.asarray(U), (ref_state, ref_ivs, summed)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes; one intra-op thread per
    worker keeps the torch side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_csmc_sweep_matches_jax_statistically(setup):
    """Seed-replicated two-sample z-test on the drawn trajectory's time
    averages (both states, front friction) and the mean ESS of K
    independent sweeps of each implementation."""
    jmodel, tmodel, Y, U, ref = setup
    N, K = 256, 8
    run = jax.jit(jbuild_csmc(jmodel.ssm, jmodel.gps, N, dtype=F64))
    csmc = build_csmc(tmodel.ssm, tmodel.gps, N, dtype=torch.float64, device="cpu")
    ref_t = convert.reference_from_arrays(*ref, torch.float64, "cpu")
    stats_j, stats_t = [], []
    for s in range(K):
        rj = run(jax.random.key(1000 + s), Y, U, jmodel.x0, jmodel.p0, ref[0], ref[1], ref[2])
        rt = csmc(torch.Generator().manual_seed(2000 + s), Y, U, tmodel.x0, tmodel.p0, *ref_t)
        for res, out in ((rj, stats_j), (rt, stats_t)):
            x = np.asarray(res.state_traj)
            mu = np.asarray(res.int_var_traj[0])[:, 0]
            ess = np.asarray(res.ess)
            assert np.all(np.isfinite(x)) and np.all(np.isfinite(mu))
            assert np.all(ess >= 1.0 - 1e-9) and np.all(ess <= N + 1e-6)
            out.append([x[:, 0].mean(), x[:, 1].mean(), mu.mean(), ess.mean()])
    a, b = np.asarray(stats_j), np.asarray(stats_t)
    se = np.sqrt((a.var(0, ddof=1) + b.var(0, ddof=1)) / K)
    z = np.abs(a.mean(0) - b.mean(0)) / np.maximum(se, 1e-12)
    # 4 sigma with K = 8 replicates per side
    assert np.all(z < 4.0), (z, a.mean(0), b.mean(0), se)


def test_pinned_particle_follows_the_reference(setup):
    """At every step the last particle holds the reference's state and
    interface variables, and the emitted ancestry is the sorted systematic
    ancestors with the reference's ancestor in the last slot."""
    _, tmodel, Y, U, ref = setup
    N = 64
    csmc = build_csmc(tmodel.ssm, tmodel.gps, N, dtype=torch.float64, device="cpu")
    ref_t = convert.reference_from_arrays(*ref, torch.float64, "cpu")
    tr = csmc.trace(torch.Generator().manual_seed(4), Y, U, tmodel.x0, tmodel.p0, *ref_t)
    T = Y.shape[0]
    assert tr.states.shape == (T, 2, N) and tr.ancestors.shape == (T - 1, N)
    np.testing.assert_array_equal(tr.states[:, :, -1].numpy(), ref[0])
    for i in range(2):
        np.testing.assert_array_equal(tr.int_vars[i][:, :, -1].numpy(), ref[1][i])
    anc = tr.ancestors.numpy()
    assert np.all(np.diff(anc[:, :-1], axis=1) >= 0)
    assert anc.min() >= 0 and anc.max() < N
    # the reference's own line is among the ancestors its weights pick
    assert np.any(anc[:, -1] == N - 1)


def test_gibbs_result_layout(setup):
    """``build_gibbs`` with K = 3: the JAX result layout, the initial
    reference as the first draw, and outputs / log-likelihoods that match
    the JAX model evaluated at every draw."""
    jmodel, tmodel, Y, U, ref = setup
    N, K = 32, 3
    gibbs = build_gibbs(tmodel.ssm, tmodel.gps, N, K, dtype=torch.float64, device="cpu")
    seen = []
    res = gibbs(torch.Generator().manual_seed(6), Y, U, tmodel.x0, tmodel.p0, ref[0], ref[1],
                callback=lambda k, r: seen.append(k))
    T = Y.shape[0]
    assert seen == [1, 2]
    assert res.states.shape == (T, K, 2)
    assert [iv.shape for iv in res.int_vars] == [(T, K, 1)] * 2
    assert res.weights.shape == (T, K) and torch.allclose(res.weights, torch.tensor(1.0 / K, dtype=torch.float64))
    assert res.stats[0].T0.shape == (K, 20, 1) and res.stats[1].T1.shape == (K, 20, 20)
    assert res.stats[0].T3.shape == (K,)
    assert res.outputs.shape == (T, K, 2) and res.log_likelihood.shape == (T, K)
    np.testing.assert_array_equal(res.states[:, 0].numpy(), ref[0])
    for g, w in zip(res.stats[0], ref[2][0]):
        np.testing.assert_allclose(g[0].numpy(), w, rtol=1e-10, atol=1e-12)
    # T3 counts the trajectory's data
    np.testing.assert_allclose(res.stats[1].T3.numpy(), float(T))

    def out_and_ll(obs, x, inp, iv_f, iv_r):
        out = jnp.atleast_1d(jmodel.ssm.output(x, inp, iv_f, iv_r))
        return out, jmvn_logpdf_chol(obs, out, jmodel.ssm.output_chol(F64))

    per_draw = jax.vmap(out_and_ll, in_axes=(None, 0, None, 0, 0))
    want_out, want_ll = jax.jit(jax.vmap(per_draw))(
        jnp.asarray(Y), jnp.asarray(res.states.numpy()), jnp.asarray(U),
        jnp.asarray(res.int_vars[0].numpy()), jnp.asarray(res.int_vars[1].numpy()),
    )
    np.testing.assert_allclose(res.outputs.numpy(), np.asarray(want_out), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(res.log_likelihood.numpy(), np.asarray(want_ll), rtol=1e-10)
