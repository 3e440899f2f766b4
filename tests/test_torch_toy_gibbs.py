"""The port's marginalized PGAS (Algorithms 2+3) on the toy model, the
checks of the JAX package's ``tests/test_gibbs.py`` at its size (60
particles, 35 steps, 40 iterations, float64 on the CPU) and with its
bounds.

The data are the JAX package's own simulation (the same key discipline as
``tests/test_gibbs.py``), carried across as numpy; the port's sampler
then runs from a torch generator. The function-recovery and
state-tracking bounds are the JAX test's: they hold the sampler to the
same posterior, not to the same draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipk_tpu.models import toy as jtoy
from bipk_tpu_torch import convert
from bipk_tpu_torch.algorithms.apf import build_apf
from bipk_tpu_torch.algorithms.csmc import build_csmc
from bipk_tpu_torch.algorithms.gibbs import build_gibbs, summed_reference_stats
from bipk_tpu_torch.models import toy
from bipk_tpu_torch.ops import mniw
from bipk_tpu_torch.utils.matio import sample_reference_trajectory

N_PARTICLES = 60
N_STEPS = 35
N_ITER = 40
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes; one intra-op thread per
    worker keeps the torch side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy_gibbs(_one_torch_thread):
    cfg = jtoy.ToyConfig(n_particles=N_PARTICLES, n_steps=N_STEPS)
    key = jax.random.key(cfg.seed)
    _, key_sim = jax.random.split(key)
    X, Y = (torch.as_tensor(np.array(a)) for a in jtoy.simulate(key_sim, cfg, dtype=jnp.float64))
    model = convert.toy_model_from_arrays(dataclasses.asdict(cfg),
                                          convert.toy_arrays(jtoy.make_model(cfg)))
    inputs = torch.zeros((N_STEPS, 0), dtype=F64)

    g = torch.Generator().manual_seed(cfg.seed)
    apf = build_apf(model.ssm, model.gps, N_PARTICLES, 1.0, dtype=F64, device="cpu")
    res1 = apf(g, Y, inputs, model.x0, model.p0)
    ref_state, ref_iv = sample_reference_trajectory(torch.rand((1,), generator=g, dtype=F64), res1)
    gibbs = build_gibbs(model.ssm, model.gps, N_PARTICLES, N_ITER, dtype=F64, device="cpu")
    res2 = gibbs(g, Y, inputs, model.x0, model.p0, ref_state, ref_iv)
    return cfg, model, X, Y, inputs, ref_state, ref_iv, res2


def test_shapes(toy_gibbs):
    cfg, model, X, Y, inputs, ref_state, ref_iv, res = toy_gibbs
    assert res.states.shape == (N_STEPS, N_ITER, 1)
    assert res.int_vars[0].shape == (N_STEPS, N_ITER, 1)
    assert res.weights.shape == (N_STEPS, N_ITER)
    assert res.stats[0].T1.shape == (N_ITER, cfg.n_basis, cfg.n_basis)
    assert res.outputs.shape == (N_STEPS, N_ITER, 1)
    assert res.log_likelihood.shape == (N_STEPS, N_ITER)
    np.testing.assert_allclose(res.weights.numpy(), 1.0 / N_ITER)


def test_first_iteration_is_reference(toy_gibbs):
    cfg, model, X, Y, inputs, ref_state, ref_iv, res = toy_gibbs
    np.testing.assert_allclose(res.states[:, 0, :].numpy(), ref_state.numpy(), rtol=1e-9)


def test_iterations_mix(toy_gibbs):
    """Successive Gibbs draws differ (the chain moves)."""
    cfg, model, X, Y, inputs, ref_state, ref_iv, res = toy_gibbs
    diffs = np.abs(np.diff(res.states[:, :, 0].numpy(), axis=1)).mean(0)
    assert np.all(diffs > 1e-3), diffs.min()


def test_posterior_function_recovery(toy_gibbs):
    """Averaged sufficient statistics over the second half of the chain
    recover the true sub-function within the data range (the JAX test's
    bound, rmse < 6.5 against a +-10-range target)."""
    cfg, model, X, Y, inputs, ref_state, ref_iv, res = toy_gibbs
    half = N_ITER // 2
    prior = model.gp.prior_as(F64, "cpu")
    post = mniw.MNIW(*(p + s[half:].mean(0) for p, s in zip(prior, res.stats[0])))
    A = mniw.posterior_mean(post)
    lo, hi = np.quantile(X.numpy(), [0.1, 0.9])
    xs = torch.linspace(float(lo), float(hi), 101, dtype=F64)
    fit = A[0] @ model.basis.eigen_fn_bl(xs)
    rmse = float(((fit - toy.f_true(xs)) ** 2).mean().sqrt())
    assert rmse < 6.5, rmse


def test_posterior_state_tracking(toy_gibbs):
    """Interface variables track the latent state (the toy observation is
    the interface variable; the filter state lags one step)."""
    cfg, model, X, Y, inputs, ref_state, ref_iv, res = toy_gibbs
    half = N_ITER // 2
    post_mean = res.int_vars[0][:, half:, 0].numpy().mean(axis=1)
    rmse = np.sqrt(np.mean((post_mean[5:] - X.numpy()[5:, 0]) ** 2))
    assert rmse < 2.5, rmse


def test_csmc_pins_reference(toy_gibbs):
    """A cSMC sweep conditioned on the initial reference returns finite
    trajectories, and its ESS stays healthy."""
    cfg, model, X, Y, inputs, ref_state, ref_iv, res = toy_gibbs
    csmc = build_csmc(model.ssm, model.gps, N_PARTICLES, dtype=F64, device="cpu")
    ref_stats = summed_reference_stats(model.gps, ref_state, ref_iv, inputs, F64)
    out = csmc(torch.Generator().manual_seed(99), Y, inputs, model.x0, model.p0,
               ref_state, ref_iv, ref_stats)
    assert out.state_traj.shape == (N_STEPS, 1)
    assert torch.isfinite(out.state_traj).all()
    assert torch.isfinite(out.log_weights).all()
    assert float(out.ess.mean()) > 0.2 * N_PARTICLES
