"""One step of the port's cSMC sweep on the toy model (m = 40, one GP, a
deterministic transition, zero-width inputs ``(T, 0)``) against the JAX
package's ``build_csmc`` on one CPU device, exactly.

The JAX sweep's initial carry and the draws its first step takes (the key
splits of ``csmc.py:264,285,302,312``; the toy's transition takes no
noise, so the state key goes unused, and its ancestor weights drop the
transition density ``h_x``) are handed to the port, and every carry field
and emitted value agrees to rtol 1e-10 in float64. The JAX carries are
read off the sweep's own ``lax.scan`` call.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipk_tpu.algorithms.apf import APFKernel as JAPFKernel
from bipk_tpu.algorithms.csmc import build_csmc as jbuild_csmc
from bipk_tpu.algorithms.gibbs import summed_reference_stats as jsummed
from bipk_tpu.models import toy as jtoy
from bipk_tpu_torch import convert
from bipk_tpu_torch.algorithms.csmc import CSMCDraws, _at, build_csmc, ref_contributions
from bipk_tpu_torch.ops import mniw as tmniw

F64 = jnp.float64
N = 128
T = 12


@pytest.fixture(scope="module")
def setup():
    cfg = jtoy.ToyConfig(n_steps=T)
    jmodel = jtoy.make_model(cfg)
    X, Y = jtoy.simulate(jax.random.key(5), cfg, dtype=F64)
    X = np.asarray(X)
    tmodel = convert.toy_model_from_arrays(dataclasses.asdict(cfg), convert.toy_arrays(jmodel))
    # the interface variable at t is the next state (x_{t+1} = iv_t)
    ref = (X, (np.concatenate([X[1:], np.asarray(jtoy.f_true(X[-1:]))]),))
    return jmodel, tmodel, np.asarray(Y), np.zeros((T, 0)), ref


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


@pytest.fixture(scope="module")
def jax_csmc_step(setup):
    """The JAX sweep's initial carry, the first step's inputs, and the
    carry and emits after it, read off the sweep's own ``lax.scan`` over
    one step. The reference's summed statistics are those of the whole
    trajectory, so its future statistics are a realistic offset."""
    jmodel, _, Y, U, (ref_state, ref_ivs) = setup
    summed = jsummed((jmodel.gp,), jnp.asarray(ref_state), tuple(map(jnp.asarray, ref_ivs)),
                     jnp.asarray(U), F64)
    captured = []
    real_scan = jax.lax.scan

    def spy(f, init, xs, *args, **kwargs):
        out = real_scan(f, init, xs, *args, **kwargs)
        if getattr(f, "__name__", "") == "step_direct":
            jax.debug.callback(lambda *a: captured.append(a), init, xs, out)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.lax, "scan", spy)
    key = jax.random.key(11)
    try:
        run = jax.jit(jbuild_csmc(jmodel.ssm, (jmodel.gp,), N, dtype=F64))
        jax.block_until_ready(run(
            key, Y[:2], U[:2], jmodel.x0, jmodel.p0, ref_state[:2],
            tuple(r[:2] for r in ref_ivs), summed,
        ))
    finally:
        mp.undo()
    (carry0, xs, (carry1, emits)), = captured
    xs0, emits = (jax.tree_util.tree_map(lambda a: a[0], t) for t in (xs, emits))
    return key, summed, carry0, xs0, carry1, emits


def _port_ref(tmodel, U, ref):
    ref_state, ref_ivs = _t(ref[0]), tuple(map(_t, ref[1]))
    return ref_state, ref_ivs, ref_contributions(tmodel.gps, ref_state, ref_ivs, _t(U))


def test_toy_csmc_initial_pinning_matches_jax_exactly(setup, jax_csmc_step):
    jmodel, tmodel, _, U, ref = setup
    key, summed, carry0, _, _, _ = jax_csmc_step
    _, key_init = jax.random.split(key)
    lw, state, iv, stats = JAPFKernel(jmodel.ssm, (jmodel.gp,), F64).init_particles(
        key_init, N, jnp.asarray(U[0]), jnp.asarray(jmodel.x0), jnp.asarray(jmodel.p0)
    )
    particles = convert.packed_carry_from_arrays(
        lw, state, iv, [tuple(np.asarray(a) for a in st) for st in stats], torch.float64, "cpu",
    )
    assert particles[3][0].shape == (tmniw.packed_rows(40, 1), N)
    csmc = build_csmc(tmodel.ssm, tmodel.gps, N, dtype=torch.float64, device="cpu")
    ref_state, ref_ivs, ref_T = _port_ref(tmodel, U, ref)
    _, _, summed_t = convert.reference_from_arrays(ref[0], ref[1], summed, torch.float64, "cpu")
    got = csmc.pin_initial(particles, ref_state[0], tuple(r[0] for r in ref_ivs),
                           _at(ref_T, 0), summed_t)
    for g, w in zip(got[:2], carry0[:2]):
        _close(g, w)
    _close(got[2][0], carry0[2][0])
    _close(got[3][0], carry0[3][0])
    for g, w in zip(got[4][0], carry0[4][0]):
        _close(g, w)


def test_toy_csmc_one_step_matches_jax_exactly(setup, jax_csmc_step):
    _, tmodel, Y, U, ref = setup
    _, _, carry0, xs0, carry1, emits = jax_csmc_step
    k = xs0[-1]
    k, key_res = jax.random.split(k)
    k, key_ref = jax.random.split(k)
    k, _ = jax.random.split(k)  # the state key: no process noise to draw
    k, key_iv = jax.random.split(k)
    (k_gp,) = jax.random.split(key_iv, 1)
    ku, kv = jax.random.split(k_gp)
    draws = CSMCDraws(
        _t(jax.random.uniform(key_res, dtype=F64)).reshape(1),
        _t(jax.random.uniform(key_ref, dtype=F64)).reshape(1),
        None,
        ((_t(jax.random.uniform(ku, (1, N), F64)), _t(jax.random.uniform(kv, (1, N), F64))),),
    )
    carry = (
        _t(carry0[0]), _t(carry0[1]), tuple(map(_t, carry0[2])), tuple(map(_t, carry0[3])),
        tuple(tmniw.MNIW(*map(_t, st)) for st in carry0[4]),
    )
    csmc = build_csmc(tmodel.ssm, tmodel.gps, N, dtype=torch.float64, device="cpu")
    assert csmc.kern.process_chol is None  # deterministic: h_x is dropped
    ref_state, ref_ivs, ref_T = _port_ref(tmodel, U, ref)
    got, (ancestors, ess) = csmc.step(
        carry, _t(Y[1]), _t(U[0]), _t(U[1]), ref_state[1],
        tuple(r[1] for r in ref_ivs), _at(ref_T, 1), draws,
    )
    _close(got[0], carry1[0])
    _close(got[1], carry1[1])
    _close(got[2][0], carry1[2][0])
    _close(got[3][0], carry1[3][0])
    for g, w in zip(got[4][0], carry1[4][0]):
        _close(g, w)
    np.testing.assert_array_equal(ancestors.numpy(), np.asarray(emits[3]))
    _close(ess, emits[4])
    # the reference is pinned: its state, and the deterministic
    # transition's state is the gathered interface variable
    _close(got[1][:, -1], ref[0][1])
