"""One step of the port's online APF on the single-mass oscillator (m = 41,
one GP, the cs-layout width of the JAX package's kernels) against the JAX
package's ``build_sharded_apf`` on one CPU device, exactly.

The JAX sweep's initial carry and the draws its step takes (the key splits
of ``sharded.py:244-248`` and the draw-update's ``key_u, key_v`` split, one
GP) are handed to the port's step, and every carry field and moment agrees
to rtol 1e-10 in float64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipk_tpu.algorithms.apf import APFKernel as JAPFKernel
from bipk_tpu.models import oscillator as josc
from bipk_tpu.ops import mniw as jmniw
from bipk_tpu.parallel.mesh import particle_mesh
from bipk_tpu.parallel.sharded import build_sharded_apf as jbuild
from bipk_tpu_torch import convert
from bipk_tpu_torch.ops import mniw as tmniw
from bipk_tpu_torch.parallel.sharded import StepDraws, build_sharded_apf

LAM = 0.999
F64 = jnp.float64
T = 2  # steps of the simulated data: one filter step


@pytest.fixture(scope="module")
def setup():
    cfg = josc.OscillatorConfig(t_end=T * 0.02)
    jmodel = josc.make_model(cfg)
    _, Y, _, U = josc.simulate(jax.random.key(5), cfg, dtype=F64)
    tmodel = convert.oscillator_model_from_arrays(
        dataclasses.asdict(cfg), convert.oscillator_arrays(jmodel))
    return cfg, jmodel, tmodel, np.asarray(Y), np.asarray(U)


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


def test_one_step_matches_jax_exactly(setup):
    _, jmodel, tmodel, Y, U = setup
    N = 128
    key = jax.random.key(7)
    key_scan, key_init = jax.random.split(key)
    jkern = JAPFKernel(jmodel.ssm, (jmodel.gp,), F64)
    init = jkern.init_particles(
        jax.random.fold_in(key_init, 0), N, jnp.asarray(U[0]),
        jnp.asarray(jmodel.x0), jnp.asarray(jmodel.p0),
    )
    step_key = jax.random.split(key_scan, 1)[0]
    key_res, key_draws = jax.random.split(step_key)
    key_state, key_iv = jax.random.split(jax.random.fold_in(key_draws, 0))
    u_res = jax.random.uniform(jax.random.fold_in(key_res, 0), dtype=F64)
    z = jax.random.normal(key_state, (2, N), F64)
    (k_gp,) = jax.random.split(key_iv, 1)
    ku, kv = jax.random.split(k_gp)
    u, v = jax.random.uniform(ku, (1, N), F64), jax.random.uniform(kv, (1, N), F64)

    run = jax.jit(jbuild(jmodel.ssm, (jmodel.gp,), N, particle_mesh(1), LAM, dtype=F64))
    want = run(key, Y[:2], U[:2], jmodel.x0, jmodel.p0)

    apf = build_sharded_apf(tmodel.ssm, tmodel.gps, N, forgetting_factor=LAM,
                            dtype=torch.float64, device="cpu")
    lw0, state0, iv0, stats0 = init
    carry0 = convert.packed_carry_from_arrays(
        lw0, state0, iv0, [tuple(np.asarray(a) for a in st) for st in stats0],
        torch.float64, "cpu",
    )
    assert carry0[3][0].shape == (tmniw.packed_rows(41, 1), N)
    draws = StepDraws(_t(u_res).reshape(1), _t(z), ((_t(u), _t(v)),))
    m0 = apf.moments(torch.softmax(carry0[0], 0), *carry0[1:])
    carry1, m1 = apf.step(carry0, _t(Y[1]), _t(U[0]), _t(U[1]), draws)
    got = apf.finish([m0, m1], carry1)

    _close(got.final_state, want.final_state)
    _close(got.final_log_weights, want.final_log_weights)
    _close(got.state_mean, want.state_mean)
    _close(got.ess, want.ess)
    _close(got.int_var_mean[0], want.int_var_mean[0])
    for g, w in zip(got.stats_mean[0], want.stats_mean[0]):
        _close(g, w)
    for g, w in zip(got.final_stats[0], want.final_stats[0]):
        _close(g, w)
    _close(carry1[3][0], jmniw.pack_stats_bl(want.final_stats[0]))
