"""One step of the port's online APF (vehicle model) against the JAX
package's ``build_sharded_apf`` on one CPU device, exactly.

The JAX sweep's initial carry and the draws its step takes (the key splits
of ``sharded.py:244-248``, ``apf.py:155`` and the draw-update's ``key_u,
key_v`` split) are handed to the port's step; every carry field and moment
agrees to rtol 1e-10 in float64. Also holds the converted model against
the port's own ``make_model``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipk_tpu.algorithms.apf import APFKernel as JAPFKernel
from bipk_tpu.models import vehicle as jveh
from bipk_tpu.ops import mniw as jmniw
from bipk_tpu.parallel.mesh import particle_mesh
from bipk_tpu.parallel.sharded import build_sharded_apf as jbuild
from bipk_tpu_torch import convert
from bipk_tpu_torch.models import vehicle as tveh
from bipk_tpu_torch.ops import mniw as tmniw
from bipk_tpu_torch.parallel.sharded import StepDraws, build_sharded_apf

LAM = 0.999


def _arrays(model):
    """The JAX vehicle model's arrays, as numpy (``convert`` docstring)."""
    return dict(
        sqrt_eigenvalues=np.asarray(model.basis.sqrt_eigenvalues),
        centers=np.asarray(model.basis.centers),
        half_widths=np.asarray(model.basis.half_widths),
        spectral_density=np.asarray(model.basis.spectral_density),
        priors=[tuple(np.asarray(p) for p in gp.prior) for gp in model.gps],
        process_noise=np.asarray(model.ssm.process_noise),
        output_noise=np.asarray(model.ssm.output_noise),
        init_cov=np.asarray(model.gps[0].init_cov),
        x0=np.asarray(model.x0),
        p0=np.asarray(model.p0),
    )


@pytest.fixture(scope="module")
def setup():
    cfg = jveh.VehicleConfig(t_end=25 * 0.02)
    jmodel = jveh.make_model(cfg)
    _, Y, _, _, U = jveh.simulate(jax.random.key(5), cfg, dtype=jnp.float64)
    tmodel = convert.vehicle_model_from_arrays(dataclasses.asdict(cfg), _arrays(jmodel))
    return cfg, jmodel, tmodel, np.asarray(Y), np.asarray(U)


def _close(got, want, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes; one intra-op thread per
    worker keeps the torch side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_converted_model_matches_native_port(setup):
    cfg, _, tmodel, _, _ = setup
    native = tveh.make_model(tveh.VehicleConfig(**dataclasses.asdict(cfg)))
    for a, b in zip(tmodel.gps, native.gps):
        for p, q in zip(a.prior, b.prior):
            _close(p, q)
    x = torch.linspace(-0.3, 0.3, 50, dtype=torch.float64)
    _close(tmodel.basis.eigen_fn_bl(x), native.basis.eigen_fn_bl(x))
    _close(tmodel.p0, native.p0)


@pytest.fixture(scope="module")
def jax_step(setup):
    """The JAX sweep's initial carry, the first step's draws (the JAX
    sweep's own key discipline, single device: shard index 0) and the
    sweep's result after that step."""
    _, jmodel, _, Y, U = setup
    N = 256
    key = jax.random.key(7)
    f64 = jnp.float64
    key_scan, key_init = jax.random.split(key)
    jkern = JAPFKernel(jmodel.ssm, jmodel.gps, f64)
    init = jkern.init_particles(
        jax.random.fold_in(key_init, 0), N, jnp.asarray(U[0]),
        jnp.asarray(jmodel.x0), jnp.asarray(jmodel.p0),
    )
    step_key = jax.random.split(key_scan, 1)[0]
    key_res, key_draws = jax.random.split(step_key)
    key_state, key_iv = jax.random.split(jax.random.fold_in(key_draws, 0))
    u_res = jax.random.uniform(jax.random.fold_in(key_res, 0), dtype=f64)
    z = jax.random.normal(key_state, (2, N), f64)
    uvs = []
    for k in jax.random.split(key_iv, 2):
        ku, kv = jax.random.split(k)
        uvs.append((jax.random.uniform(ku, (1, N), f64), jax.random.uniform(kv, (1, N), f64)))

    run = jax.jit(jbuild(jmodel.ssm, jmodel.gps, N, particle_mesh(1), LAM, dtype=f64))
    want = run(key, Y[:2], U[:2], jmodel.x0, jmodel.p0)
    return N, init, (u_res, z, uvs), want


def _check_one_step(setup, jax_step, **options):
    """The port's step from the JAX carry with the JAX draws, under the
    gather/draw ``options`` of ``build_sharded_apf``, against the JAX
    step (which computes the same function in every configuration)."""
    _, _, tmodel, Y, U = setup
    N, init, (u_res, z, uvs), want = jax_step

    def t(a):
        return torch.as_tensor(np.array(a), dtype=torch.float64)

    apf = build_sharded_apf(tmodel.ssm, tmodel.gps, N, forgetting_factor=LAM,
                            dtype=torch.float64, device="cpu", **options)
    lw0, state0, iv0, stats0 = init
    carry0 = convert.packed_carry_from_arrays(
        lw0, state0, iv0, [tuple(np.asarray(a) for a in st) for st in stats0],
        torch.float64, "cpu",
    )
    draws = StepDraws(t(u_res).reshape(1), t(z), tuple((t(u), t(v)) for u, v in uvs))
    m0 = apf.moments(torch.softmax(carry0[0], 0), carry0[1], carry0[2], carry0[3])
    carry1, m1 = apf.step(carry0, t(Y[1]), t(U[0]), t(U[1]), draws)
    got = apf.finish([m0, m1], carry1)

    _close(got.final_state, want.final_state)
    _close(got.final_log_weights, want.final_log_weights)
    _close(got.state_mean, want.state_mean)
    _close(got.ess, want.ess)
    for i in range(2):
        _close(got.int_var_mean[i], want.int_var_mean[i])
        for g, w in zip(got.stats_mean[i], want.stats_mean[i]):
            _close(g, w)
        for g, w in zip(got.final_stats[i], want.final_stats[i]):
            _close(g, w)
    # the packed carry the next step reads is the JAX final statistics
    for i in range(2):
        want_S = jmniw.pack_stats_bl(want.final_stats[i])
        _close(carry1[3][i], want_S)
        assert carry1[3][i].shape == (tmniw.packed_rows(20, 1), N)


def test_one_step_matches_jax_exactly(setup, jax_step):
    _check_one_step(setup, jax_step)


@pytest.mark.parametrize("option", ["reuse_factor", "dedup_gather"])
def test_one_step_matches_jax_exactly_opt_in(setup, jax_step, option):
    """The opt-in gather/draw configurations compute the default's
    function: the same JAX step, exactly."""
    _check_one_step(setup, jax_step, **{option: True})
