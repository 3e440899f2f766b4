"""The port's rank-1 factor-carry cSMC (``build_csmc(rank1=True)``)
against the JAX package's ``step_rank1`` and against the port's own direct
sweep, on the CPU in float64.

- The JAX sweep's initial carry (the augmented factors of the pinned
  statistics, with and without the reference's future) and its first
  step, read off the sweep's own ``lax.scan`` as ``test_torch_csmc_step``
  reads them, with the JAX draws handed to the port: every carry field and
  emitted value to rtol 1e-10. One JAX rank-1 scan, at ``n_basis = 6`` and
  40 particles, keeps the compile small.
- The port's rank-1 sweep against its direct sweep on the same draws
  (vehicle, m = 20, 40 particles, t_end 0.5): in exact arithmetic one
  sweep, here within ``tests/test_cholup.py``'s 1e-9.
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
from bipk_tpu_torch.algorithms.csmc import CSMCDraws, CSMCRank1, _at, build_csmc, ref_contributions
from bipk_tpu_torch.algorithms.gibbs import summed_reference_stats
from bipk_tpu_torch.models import vehicle as tveh

F64 = jnp.float64
N = 40


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
def setup():
    cfg = jveh.VehicleConfig(n_basis=6, t_end=10 * 0.02)
    jmodel = jveh.make_model(cfg)
    X, Y, mu_f, mu_r, U = jveh.simulate(jax.random.key(5), cfg, dtype=F64)
    tmodel = convert.vehicle_model_from_arrays(dataclasses.asdict(cfg),
                                               convert.vehicle_arrays(jmodel))
    ref = (np.asarray(X), (np.asarray(mu_f)[:, None], np.asarray(mu_r)[:, None]))
    return jmodel, tmodel, np.asarray(Y), np.asarray(U), ref


@pytest.fixture(scope="module")
def jax_rank1_step(setup):
    """The JAX rank-1 sweep's initial carry, its first step's inputs, and
    the carry and emits after it, read off the sweep's ``lax.scan``."""
    jmodel, _, Y, U, (ref_state, ref_ivs) = setup
    summed = jsummed(jmodel.gps, jnp.asarray(ref_state), tuple(map(jnp.asarray, ref_ivs)),
                     jnp.asarray(U), F64)
    captured = []
    real_scan = jax.lax.scan

    def spy(f, init, xs, *args, **kwargs):
        out = real_scan(f, init, xs, *args, **kwargs)
        if getattr(f, "__name__", "") == "step_rank1":
            jax.debug.callback(lambda *a: captured.append(a), init, xs, out)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.lax, "scan", spy)
    key = jax.random.key(13)
    try:
        run = jax.jit(jbuild_csmc(jmodel.ssm, jmodel.gps, N, dtype=F64, rank1=True))
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


def _close_carry(got, want):
    _close(got[0], want[0])
    _close(got[1], want[1])
    for field in range(2, 7):
        for g, w in zip(got[field], want[field]):
            _close(g, w)


def test_rank1_initial_factors_match_jax_exactly(setup, jax_rank1_step):
    jmodel, tmodel, _, U, ref = setup
    key, summed, carry0, _, _, _ = jax_rank1_step
    _, key_init = jax.random.split(key)
    lw, state, iv, stats = JAPFKernel(jmodel.ssm, jmodel.gps, F64).init_particles(
        key_init, N, jnp.asarray(U[0]), jnp.asarray(jmodel.x0), jnp.asarray(jmodel.p0)
    )
    particles = convert.packed_carry_from_arrays(
        lw, state, iv, [tuple(np.asarray(a) for a in st) for st in stats], torch.float64, "cpu",
    )
    csmc = build_csmc(tmodel.ssm, tmodel.gps, N, dtype=torch.float64, device="cpu", rank1=True)
    assert isinstance(csmc, CSMCRank1)
    ref_state, ref_ivs, ref_T = _port_ref(tmodel, U, ref)
    _, _, summed_t = convert.reference_from_arrays(ref[0], ref[1], summed, torch.float64, "cpu")
    got = csmc.pin_initial(particles, ref_state[0], tuple(r[0] for r in ref_ivs),
                           _at(ref_T, 0), summed_t)
    _close_carry(got, carry0)


def test_rank1_one_step_matches_jax_exactly(setup, jax_rank1_step):
    """The port's rank-1 step from the JAX carry with the JAX draws (the
    key splits of ``csmc.py``'s ``step_rank1`` and ``common_tail``, then
    ``draw_int_vars`` per GP): carry, ancestors and ESS."""
    _, tmodel, Y, U, ref = setup
    _, _, carry0, xs0, carry1, emits = jax_rank1_step
    k = xs0[-1]
    k, key_res = jax.random.split(k)
    k, key_ref = jax.random.split(k)
    k, key_state = jax.random.split(k)
    k, key_iv = jax.random.split(k)
    uvs = []
    for kk in jax.random.split(key_iv, 2):
        ku, kv = jax.random.split(kk)
        uvs.append((_t(jax.random.uniform(ku, (1, N), F64)), _t(jax.random.uniform(kv, (1, N), F64))))
    draws = CSMCDraws(
        _t(jax.random.uniform(key_res, dtype=F64)).reshape(1),
        _t(jax.random.uniform(key_ref, dtype=F64)).reshape(1),
        _t(jax.random.normal(key_state, (2, N), F64)),
        tuple(uvs),
    )
    carry = (_t(carry0[0]), _t(carry0[1]), *(tuple(map(_t, f)) for f in carry0[2:]))
    csmc = build_csmc(tmodel.ssm, tmodel.gps, N, dtype=torch.float64, device="cpu", rank1=True)
    ref_state, ref_ivs, ref_T = _port_ref(tmodel, U, ref)
    got, (ancestors, ess) = csmc.step(
        carry, _t(Y[1]), _t(U[0]), _t(U[1]), ref_state[1],
        tuple(r[1] for r in ref_ivs), _at(ref_T, 1), draws,
    )
    _close_carry(got, carry1)
    np.testing.assert_array_equal(ancestors.numpy(), np.asarray(emits[3]))
    _close(ess, emits[4])


def test_rank1_sweep_matches_direct_sweep():
    """The port's rank-1 and direct sweeps on the same draws (one
    generator seed: the same initial particles and step draws): the same
    ancestry, states and trajectory draw, log-weights within 1e-9, as
    ``tests/test_cholup.py`` bounds the JAX pair."""
    cfg = tveh.VehicleConfig(t_end=0.5)
    model = tveh.make_model(cfg)
    X, Y, mu_f, mu_r, U = tveh.simulate(torch.Generator().manual_seed(cfg.seed), cfg,
                                        dtype=torch.float64, device="cpu")
    ivs = (mu_f[:, None], mu_r[:, None])
    summed = summed_reference_stats(model.gps, X, ivs, U, torch.float64)
    out = {}
    for rank1 in (True, False):
        csmc = build_csmc(model.ssm, model.gps, N, dtype=torch.float64, device="cpu", rank1=rank1)
        g = torch.Generator().manual_seed(3)
        out[rank1] = (csmc.trace(g, Y, U, model.x0, model.p0, X, ivs, summed),
                      csmc(torch.Generator().manual_seed(4), Y, U, model.x0, model.p0, X, ivs,
                           summed))
    (tr1, res1), (trd, resd) = out[True], out[False]
    np.testing.assert_array_equal(tr1.ancestors.numpy(), trd.ancestors.numpy())
    np.testing.assert_allclose(tr1.states.numpy(), trd.states.numpy(), atol=1e-9)
    np.testing.assert_allclose(tr1.final_log_weights.numpy(), trd.final_log_weights.numpy(),
                               atol=1e-9)
    np.testing.assert_allclose(res1.state_traj.numpy(), resd.state_traj.numpy(), atol=1e-9)
    np.testing.assert_allclose(res1.log_weights.numpy(), resd.log_weights.numpy(), atol=1e-9)


@pytest.mark.parametrize("orders", [(21, 21), (5, 7, 5)])
def test_factor_maintenance_groups_factors_by_order(orders):
    """The rank-1 step's factor maintenance (one downdate and one update
    per group of GPs whose factors share an order) equals each GP's own
    update and downdate-then-update, bit for bit: the vehicle's two
    equal-order GPs, and GPs of two orders, the second group's factors
    not adjacent."""
    from bipk_tpu_torch.algorithms.csmc import _maintain_factors
    from bipk_tpu_torch.ops import cholup

    rng = np.random.default_rng(11)
    n_particles = 6

    def factor(p):
        B = rng.standard_normal((n_particles, p, p))
        A = B @ B.transpose(0, 2, 1) + p * np.eye(p)
        return torch.as_tensor(np.linalg.cholesky(A).transpose(1, 2, 0).copy())

    Fs = [factor(p) for p in orders]
    Fps = [factor(p) for p in orders]
    zs = [torch.as_tensor(rng.standard_normal((p, n_particles))) for p in orders]
    z_refs = [torch.as_tensor(0.1 * rng.standard_normal(p)) for p in orders]
    new_Fs, new_Fps = _maintain_factors(Fs, Fps, zs, z_refs)
    for F, Fp, z, zr, got_F, got_Fp in zip(Fs, Fps, zs, z_refs, new_Fs, new_Fps):
        torch.testing.assert_close(got_F, cholup.chol_rank1_update_bl(F, z), rtol=0, atol=0)
        want = cholup.chol_rank1_update_bl(cholup.chol_rank1_downdate_bl(Fp, zr), z)
        torch.testing.assert_close(got_Fp, want, rtol=0, atol=0)
