"""The port's parallel Gibbs chains (``build_gibbs(n_chains=C)``) on the
toy model, the checks of the JAX package's ``tests/test_chains.py`` that
use no mesh, at its size (50 particles, 25 steps, 30 iterations, 4
chains, float64 on the CPU) and with its bounds.

The data are the JAX package's own simulation (its key discipline, as
``tests/test_torch_toy_gibbs.py`` takes it), carried across as numpy; the
port's chains then run from one torch generator, each on a generator of
its own drawn from it. Each chain is held bit for bit against the
single-chain sampler run on that chain's generator; the posterior and
R-hat bounds are the JAX test's, which hold the chains to the same
posterior, not to the same draws.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipk_tpu.models import toy as jtoy
from bipk_tpu_torch import convert
from bipk_tpu_torch.algorithms.gibbs import (ParallelGibbs, build_gibbs, chain_generators,
                                             select_chain)
from bipk_tpu_torch.utils import diagnostics

N_PARTICLES = 50
N_STEPS = 25
N_ITER = 30
N_CHAINS = 4
N_SAME = 4  # iterations of each chain held bit for bit against the single-chain sampler
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
def chain_run(_one_torch_thread):
    cfg = jtoy.ToyConfig(n_particles=N_PARTICLES, n_steps=N_STEPS)
    key = jax.random.key(cfg.seed)
    _, key_sim = jax.random.split(key)
    X, Y = (torch.as_tensor(np.array(a)) for a in jtoy.simulate(key_sim, cfg, dtype=jnp.float64))
    model = convert.toy_model_from_arrays(dataclasses.asdict(cfg),
                                          convert.toy_arrays(jtoy.make_model(cfg)))
    inputs = torch.zeros((N_STEPS, 0), dtype=F64)
    ref_state = torch.zeros((N_STEPS, 1), dtype=F64)
    ref_iv = (torch.zeros((N_STEPS, 1), dtype=F64),)

    g = torch.Generator().manual_seed(cfg.seed)
    g_state = g.get_state()
    gibbs = build_gibbs(model.ssm, model.gps, N_PARTICLES, N_ITER, dtype=F64, device="cpu",
                        n_chains=N_CHAINS)
    refs = {}
    res = gibbs(g, Y, inputs, model.x0, model.p0, ref_state, ref_iv,
                callback=lambda k, ref: refs.setdefault(k, ref))
    return SimpleNamespace(cfg=cfg, model=model, X=X, Y=Y, inputs=inputs, ref_state=ref_state,
                           ref_iv=ref_iv, g_state=g_state, res=res, refs=refs)


def test_chain_shapes(chain_run):
    res, m = chain_run.res, chain_run.cfg.n_basis
    assert res.states.shape == (N_CHAINS, N_STEPS, N_ITER, 1)
    assert res.int_vars[0].shape == (N_CHAINS, N_STEPS, N_ITER, 1)
    assert res.weights.shape == (N_CHAINS, N_STEPS, N_ITER)
    assert res.stats[0].T1.shape == (N_CHAINS, N_ITER, m, m)
    assert res.stats[0].T3.shape == (N_CHAINS, N_ITER)
    assert res.outputs.shape == (N_CHAINS, N_STEPS, N_ITER, 1)
    assert res.log_likelihood.shape == (N_CHAINS, N_STEPS, N_ITER)
    assert torch.isfinite(res.states).all() and torch.isfinite(res.log_likelihood).all()


def test_callback_receives_the_chains_stacked(chain_run):
    """``callback(k, ref)`` gets every chain's new reference stacked along
    a leading C: the state, each interface variable and the summed
    statistics of iteration k."""
    res, refs = chain_run.res, chain_run.refs
    assert sorted(refs) == list(range(1, N_ITER))
    for k in (1, N_ITER - 1):
        state, ivs, stats = refs[k]
        assert torch.equal(state, res.states[:, :, k])
        assert torch.equal(ivs[0], res.int_vars[0][:, :, k])
        for leaf, want in zip(stats[0], res.stats[0]):
            assert torch.equal(leaf, want[:, k])


def test_chains_share_start_then_diverge(chain_run):
    """Every chain's first iteration is the shared initial reference; by
    the last iteration the chains have diverged through their draws."""
    states = chain_run.res.states.numpy()  # (C, T, K, 1)
    for c in range(N_CHAINS):
        np.testing.assert_allclose(states[c, :, 0, :], chain_run.ref_state.numpy(), rtol=1e-9)
    last = states[:, :, -1, 0]
    for c in range(1, N_CHAINS):
        assert np.abs(last[c] - last[0]).max() > 1e-3


def test_each_chain_is_the_single_chain_sampler_bit_for_bit(chain_run):
    """Chain c is ``build_gibbs`` without ``n_chains`` run on chain c's
    generator (``chain_generators`` on the caller's generator as it was):
    its first ``N_SAME`` iterations, every field, equal bit for bit."""
    r = chain_run
    g = torch.Generator()
    g.set_state(r.g_state)
    single = build_gibbs(r.model.ssm, r.model.gps, N_PARTICLES, N_SAME, dtype=F64, device="cpu")
    for c, gen in enumerate(chain_generators(g, N_CHAINS)):
        want = single(gen, r.Y, r.inputs, r.model.x0, r.model.p0, r.ref_state, r.ref_iv)
        got = select_chain(r.res, c)
        for name, g_, w in (("states", got.states, want.states),
                            ("int_vars", got.int_vars[0], want.int_vars[0]),
                            ("outputs", got.outputs, want.outputs),
                            ("log_likelihood", got.log_likelihood, want.log_likelihood)):
            assert torch.equal(g_[:, :N_SAME], w), (c, name)
        for leaf, w in zip(got.stats[0], want.stats[0]):
            assert torch.equal(leaf[:N_SAME], w), c


def test_chain_matches_single_chain_distribution(chain_run):
    """The chains are statistically the single-chain sampler: the
    cross-chain posterior mean of the interface variable tracks the latent
    state as well as the single-chain test asks (the JAX test's bound)."""
    half = N_ITER // 2
    post = chain_run.res.int_vars[0][:, :, half:, 0].numpy().mean(axis=(0, 2))
    rmse = np.sqrt(np.mean((post[5:] - chain_run.X.numpy()[5:, 0]) ** 2))
    assert rmse < 2.5, rmse


def test_per_chain_initial_references(chain_run):
    """Per-chain ``(C, T, ...)`` initial references are honoured per
    chain."""
    r = chain_run
    per_chain = torch.stack([r.ref_state + 0.1 * c for c in range(N_CHAINS)])
    ivs = (torch.stack([r.ref_iv[0] + 0.1 * c for c in range(N_CHAINS)]),)
    gibbs = build_gibbs(r.model.ssm, r.model.gps, N_PARTICLES, 2, dtype=F64, device="cpu",
                        n_chains=N_CHAINS)
    res2 = gibbs(torch.Generator().manual_seed(5), r.Y, r.inputs, r.model.x0, r.model.p0,
                 per_chain, ivs)
    for c in range(N_CHAINS):
        np.testing.assert_allclose(res2.states[c, :, 0].numpy(), per_chain[c].numpy(), rtol=1e-9)
        np.testing.assert_allclose(res2.int_vars[0][c, :, 0].numpy(), ivs[0][c].numpy(),
                                   rtol=1e-9)
    with pytest.raises(ValueError, match="n_chains=4"):
        gibbs(torch.Generator(), r.Y, r.inputs, r.model.x0, r.model.p0, per_chain[:3],
              (ivs[0][:3],))


def test_rhat_on_mixed_chains(chain_run):
    """After burn-in the four chains target one posterior: the split R-hat
    of the per-iteration trajectory mean is near 1, and a deliberately
    broken chain set is flagged (the JAX test's bounds); the summary's
    R-hat and bulk ESS are finite."""
    res = chain_run.res
    half = N_ITER // 2
    draws = res.int_vars[0][:, :, half:, 0].mean(1)  # (C, K)
    rhat = float(diagnostics.split_rhat(draws))
    assert rhat < 1.7, rhat  # short chains: loose but real bound
    broken = draws.clone()
    broken[0] += 50.0
    assert float(diagnostics.split_rhat(broken)) > 2.0
    (summary,) = diagnostics.gibbs_chain_summary(res.int_vars, half)
    assert not summary["stuck"] and summary["n_draws"] == N_CHAINS * (N_ITER - half)
    assert np.isfinite(summary["rhat"]) and np.isfinite(summary["ess"])


def test_build_gibbs_chain_guards():
    """The JAX package's refusals raise ``ValueError``; the chain mesh
    itself is not ported and raises ``NotImplementedError``."""
    cfg = jtoy.ToyConfig(n_particles=8, n_steps=4)
    model = convert.toy_model_from_arrays(dataclasses.asdict(cfg),
                                          convert.toy_arrays(jtoy.make_model(cfg)))

    def build(**kw):
        return build_gibbs(model.ssm, model.gps, 8, 4, device="cpu", **kw)

    with pytest.raises(ValueError, match=">= 2"):
        build(n_chains=1)
    with pytest.raises(ValueError, match="requires n_chains"):
        build(chain_mesh=object())
    for mesh in ("mesh", "shard_mesh"):
        with pytest.raises(ValueError, match="chain_mesh"):
            build(n_chains=2, **{mesh: object()})
    with pytest.raises(NotImplementedError, match="Queue A item 2"):
        build(n_chains=2, chain_mesh=object())
    assert isinstance(build(n_chains=2), ParallelGibbs)
