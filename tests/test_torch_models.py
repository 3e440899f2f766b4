"""The port's toy and single-mass-oscillator models, and the unbatched
MNIW helpers they need, against the JAX package on the CPU.

The same float64 inputs, made from a numpy seed, go through the JAX
function and its counterpart in ``bipk_tpu_torch``; the arithmetic is the
same up to summation order, so the tolerance is rtol 1e-10. The models
are compared both as the port builds them itself and as ``convert``
carries them across from the JAX models' arrays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipk_tpu.models import oscillator as josc
from bipk_tpu.models import toy as jtoy
from bipk_tpu.ops import mniw as jmniw
from bipk_tpu_torch import convert
from bipk_tpu_torch.models import oscillator as tosc
from bipk_tpu_torch.models import toy as ttoy
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


def _models(name):
    """(JAX model, port model, port model converted from the JAX arrays)."""
    if name == "toy":
        cfg = jtoy.ToyConfig()
        return (jtoy.make_model(cfg), ttoy.make_model(ttoy.ToyConfig()),
                convert.toy_model_from_arrays(dataclasses.asdict(cfg),
                                              convert.toy_arrays(jtoy.make_model(cfg))))
    cfg = josc.OscillatorConfig()
    return (josc.make_model(cfg), tosc.make_model(tosc.OscillatorConfig()),
            convert.oscillator_model_from_arrays(dataclasses.asdict(cfg),
                                                 convert.oscillator_arrays(josc.make_model(cfg))))


@pytest.mark.parametrize("name,m,dims", [("toy", 40, 1), ("oscillator", 41, 2)])
def test_model_basis_prior_and_noises_match_jax(name, m, dims):
    jm, tm, cm = _models(name)
    rng = np.random.default_rng(m)
    x = rng.uniform(-5.0, 5.0, (dims, 300))
    want_phi = jm.basis.eigen_fn_bl(jnp.asarray(x))
    for model in (tm, cm):
        assert model.gp.basis_dim == m and len(model.gps) == 1
        _close(model.basis.sqrt_eigenvalues, jm.basis.sqrt_eigenvalues)
        _close(model.basis.spectral_density, jm.basis.spectral_density)
        _close(model.gp.basis_fn_bl(_t(x), torch.zeros((0,))), want_phi)
        for a, b in zip(model.gp.prior, jm.gp.prior):
            _close(a, b)
        _close(model.gp.init_mean, jm.gp.init_mean)
        _close(model.gp.init_cov, jm.gp.init_cov)
        _close(model.ssm.process_noise, jm.ssm.process_noise)
        _close(model.ssm.output_noise, jm.ssm.output_noise)
        _close(model.x0, jm.x0)
        _close(model.p0, jm.p0)
        assert model.ssm.is_deterministic == jm.ssm.is_deterministic


def test_toy_dynamics_match_jax():
    jm, tm, _ = _models("toy")
    rng = np.random.default_rng(3)
    x = rng.uniform(-30.0, 30.0, 200)
    _close(ttoy.f_true(_t(x)), jtoy.f_true(jnp.asarray(x)))
    _close(ttoy.f_true(x), jtoy.f_true(jnp.asarray(x)))
    state, iv = rng.standard_normal((1, 50)), rng.standard_normal((1, 50))
    inp = torch.zeros((0,), dtype=torch.float64)
    jt = jax.vmap(lambda s, i: jm.ssm.transition(s, jnp.zeros((0,)), i), 1, 1)
    _close(tm.ssm.transition(_t(state), inp, _t(iv)), jt(jnp.asarray(state), jnp.asarray(iv)))
    _close(tm.ssm.output(_t(state), inp, _t(iv)), _t(iv))
    assert tm.ssm.is_deterministic


def test_oscillator_physics_match_jax():
    jm, tm, _ = _models("oscillator")
    cfg = tosc.OscillatorConfig()
    rng = np.random.default_rng(4)
    N = 40
    x = rng.standard_normal((2, N))
    f_sd = rng.standard_normal(N)
    _close(tosc.spring_force(_t(x[0])), josc.spring_force(jnp.asarray(x[0])))
    _close(tosc.damper_force(_t(x[1])), josc.damper_force(jnp.asarray(x[1])))
    _close(tosc.external_force(cfg), josc.external_force(josc.OscillatorConfig()))
    assert cfg.n_steps == josc.OscillatorConfig().n_steps == 750
    u = np.array([0.7])
    jtrans = jax.vmap(lambda xx, f: jm.ssm.transition(xx, jnp.asarray(u), f[None]),
                      in_axes=(1, 0), out_axes=1)
    _close(tm.ssm.transition(_t(x), _t(u), _t(f_sd)[None]),
           jtrans(jnp.asarray(x), jnp.asarray(f_sd)))
    # the output is the position: (N,) from a batch-last state
    out = tm.ssm.output(_t(x), _t(u), _t(f_sd)[None])
    assert out.shape == (N,)
    _close(out, x[0])


def test_oscillator_simulation_runs_its_physics():
    """The port's simulation (its own torch noise) follows its own RK4
    skeleton: each state is the transition of the previous one under the
    recorded force, up to the process noise's size."""
    cfg = tosc.OscillatorConfig(t_end=40 * 0.02)
    X, Y, F, U = tosc.simulate(torch.Generator().manual_seed(0), cfg, dtype=torch.float64,
                               device="cpu")
    assert X.shape == (40, 2) and Y.shape == (40, 1) and F.shape == (40, 1) and U.shape == (40, 1)
    _close(F[:-1, 0], tosc.spring_force(X[:-1, 0]) + tosc.damper_force(X[:-1, 1]))
    pred = tosc.transition(X[:-1].T, U[:-1, 0], F[:-1, 0], cfg.dt).T
    assert float((pred - X[1:]).abs().max()) < 1e-3  # sqrt(5e-8) * 5 sigma
    assert float(Y[0]) == 0.0 and float(F[-1]) == 0.0


def test_unbatched_mniw_helpers_match_jax():
    rng = np.random.default_rng(11)
    m, n = 9, 2
    w = rng.standard_normal((m, m + 3))
    A = w @ w.T + 0.2 * np.eye(m)
    B = rng.standard_normal((m, n))
    _close(tmniw.chol_spd(_t(A)), jmniw.chol_spd(jnp.asarray(A)))
    _close(tmniw.solve_spd(_t(A), _t(B)), jmniw.solve_spd(jnp.asarray(A), jnp.asarray(B)))
    _close(tmniw.solve_spd(_t(A), _t(B[:, 0])),
           jmniw.solve_spd(jnp.asarray(A), jnp.asarray(B[:, 0])))
    mean, psi = rng.standard_normal((n, m)), np.array([[1.5, 0.2], [0.2, 0.8]])
    want = jmniw.natural_from_standard(jnp.asarray(mean), jnp.asarray(A), jnp.asarray(psi), 4.0)
    got = tmniw.natural_from_standard(mean, A, psi, 4.0)
    for g, wv in zip(got, want):
        _close(g, wv)
    nat = tmniw.MNIW(*map(_t, got))
    for g, wv in zip(tmniw.standard_from_natural(nat), jmniw.standard_from_natural(want)):
        _close(g, wv)
    _close(tmniw.standard_from_natural(nat)[0], mean)
    _close(tmniw.posterior_mean(nat), jmniw.posterior_mean(want))
    # f32 takes the relative jitter on the diagonal
    L32 = tmniw.chol_spd(torch.as_tensor(A, dtype=torch.float32))
    _close(L32.double(), jmniw.chol_spd(jnp.asarray(A, jnp.float32)), rtol=1e-5, atol=1e-5)
