"""One step of the port's cSMC sweep (vehicle model) against the JAX
package's ``build_csmc`` on one CPU device, exactly.

The JAX sweep's initial carry and the draws its first step takes (the key
splits of ``csmc.py:264,285,302,312``, then ``mniw.py:877-880`` per GP)
are handed to the port; every carry field and emitted value agrees to
rtol 1e-10 in float64. The JAX carries are read off the sweep's own
``lax.scan`` call, so the comparison covers the carry the sweep really
builds: the pinned initial particle, the packed statistics and the
reference's future statistics.
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
from bipk_tpu.models import vehicle as jveh
from bipk_tpu_torch import convert
from bipk_tpu_torch.algorithms.csmc import CSMCDraws, _at, build_csmc, ref_contributions
from bipk_tpu_torch.ops import mniw as tmniw

F64 = jnp.float64
N = 256


@pytest.fixture(scope="module")
def setup():
    cfg = jveh.VehicleConfig(t_end=25 * 0.02)
    jmodel = jveh.make_model(cfg)
    X, Y, mu_f, mu_r, U = jveh.simulate(jax.random.key(5), cfg, dtype=F64)
    tmodel = convert.vehicle_model_from_arrays(dataclasses.asdict(cfg), convert.vehicle_arrays(jmodel))
    ref = (np.asarray(X), (np.asarray(mu_f)[:, None], np.asarray(mu_r)[:, None]))
    return jmodel, tmodel, np.asarray(Y), np.asarray(U), ref


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


def _uvs(key_iv, N):
    """Per GP ``(u, v)``: the draw-update's key split (``mniw.py:877-880``
    and the XLA path's ``student_t``)."""
    out = []
    for k in jax.random.split(key_iv, 2):
        ku, kv = jax.random.split(k)
        out.append((_t(jax.random.uniform(ku, (1, N), F64)), _t(jax.random.uniform(kv, (1, N), F64))))
    return tuple(out)


@pytest.fixture(scope="module")
def jax_csmc_step(setup):
    """The JAX sweep's initial carry, the first step's inputs, and the
    carry and emits after it, read off the sweep's own ``lax.scan`` over
    one step. The reference's summed statistics are those of the whole
    25-step trajectory, so its future statistics are a realistic offset."""
    jmodel, _, Y, U, (ref_state, ref_ivs) = setup
    summed = jsummed(jmodel.gps, jnp.asarray(ref_state), tuple(map(jnp.asarray, ref_ivs)),
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
        run = jax.jit(jbuild_csmc(jmodel.ssm, jmodel.gps, N, dtype=F64))
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


def test_csmc_initial_pinning_matches_jax_exactly(setup, jax_csmc_step):
    jmodel, tmodel, _, U, ref = setup
    key, summed, carry0, _, _, _ = jax_csmc_step
    _, key_init = jax.random.split(key)
    lw, state, iv, stats = JAPFKernel(jmodel.ssm, jmodel.gps, F64).init_particles(
        key_init, N, jnp.asarray(U[0]), jnp.asarray(jmodel.x0), jnp.asarray(jmodel.p0)
    )
    particles = convert.packed_carry_from_arrays(
        lw, state, iv, [tuple(np.asarray(a) for a in st) for st in stats], torch.float64, "cpu",
    )
    csmc = build_csmc(tmodel.ssm, tmodel.gps, N, dtype=torch.float64, device="cpu")
    ref_state, ref_ivs, ref_T = _port_ref(tmodel, U, ref)
    _, _, summed_t = convert.reference_from_arrays(ref[0], ref[1], summed, torch.float64, "cpu")
    got = csmc.pin_initial(particles, ref_state[0], tuple(r[0] for r in ref_ivs),
                           _at(ref_T, 0), summed_t)
    _close(got[0], carry0[0])
    _close(got[1], carry0[1])
    for i in range(2):
        _close(got[2][i], carry0[2][i])
        _close(got[3][i], carry0[3][i])
        for g, w in zip(got[4][i], carry0[4][i]):
            _close(g, w)
    # the packed particles are untouched: the pin writes copies
    _close(particles[3][0][:, :-1], got[3][0][:, :-1])


def _check_csmc_step(setup, jax_csmc_step, **options):
    """The port's cSMC step from the JAX carry with the JAX draws, under
    the gather/draw ``options`` of ``build_csmc``, against the JAX step."""
    _, tmodel, Y, U, ref = setup
    _, _, carry0, xs0, carry1, emits = jax_csmc_step
    k = xs0[-1]
    k, key_res = jax.random.split(k)
    k, key_ref = jax.random.split(k)
    k, key_state = jax.random.split(k)
    k, key_iv = jax.random.split(k)
    draws = CSMCDraws(
        _t(jax.random.uniform(key_res, dtype=F64)).reshape(1),
        _t(jax.random.uniform(key_ref, dtype=F64)).reshape(1),
        _t(jax.random.normal(key_state, (2, N), F64)),
        _uvs(key_iv, N),
    )
    carry = (
        _t(carry0[0]), _t(carry0[1]), tuple(map(_t, carry0[2])), tuple(map(_t, carry0[3])),
        tuple(tmniw.MNIW(*map(_t, st)) for st in carry0[4]),
    )
    csmc = build_csmc(tmodel.ssm, tmodel.gps, N, dtype=torch.float64, device="cpu", **options)
    ref_state, ref_ivs, ref_T = _port_ref(tmodel, U, ref)
    Ss_before = [S.clone() for S in carry[3]]
    got, (ancestors, ess) = csmc.step(
        carry, _t(Y[1]), _t(U[0]), _t(U[1]), ref_state[1],
        tuple(r[1] for r in ref_ivs), _at(ref_T, 1), draws,
    )
    _close(got[0], carry1[0])
    _close(got[1], carry1[1])
    for i in range(2):
        _close(got[2][i], carry1[2][i])
        _close(got[3][i], carry1[3][i])
        for g, w in zip(got[4][i], carry1[4][i]):
            _close(g, w)
        # the reference's column went into the new buffer, not the carry
        _close(carry[3][i], Ss_before[i], rtol=0, atol=0)
    np.testing.assert_array_equal(ancestors.numpy(), np.asarray(emits[3]))
    _close(ess, emits[4])
    # the emitted ancestors carry the reference's ancestor in the last
    # slot; the rest are the sorted systematic ancestors
    assert np.all(np.diff(ancestors.numpy()[:-1]) >= 0)


def test_csmc_one_step_matches_jax_exactly(setup, jax_csmc_step):
    _check_csmc_step(setup, jax_csmc_step)


@pytest.mark.parametrize("option", ["reuse_factor", "dedup_gather"])
def test_csmc_one_step_matches_jax_exactly_opt_in(setup, jax_csmc_step, option):
    """The cSMC step's opt-in gather/draw configurations (with
    ``reuse_factor`` the factor of the prior plus the statistics at
    lambda = 1, emitted by the look-ahead): the same JAX step, exactly."""
    _check_csmc_step(setup, jax_csmc_step, **{option: True})
