"""One step of the port's full-trace ``build_apf`` (vehicle model)
against the JAX package's ``build_apf`` on one CPU device, exactly, and
the reference-trajectory draw that seeds PGAS.

The JAX sweep's initial carry and the draws its first step takes (the key
splits of ``apf.py:631-652``, then ``mniw.py:877-880`` per GP) are handed
to the port; every trace agrees to rtol 1e-10 in float64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipk_tpu.algorithms.apf import APFKernel as JAPFKernel
from bipk_tpu.algorithms.apf import build_apf as jbuild_apf
from bipk_tpu.models import vehicle as jveh
from bipk_tpu.utils.matio import sample_reference_trajectory as jsample_ref
from bipk_tpu_torch import convert
from bipk_tpu_torch.algorithms.apf import StepDraws, build_apf
from bipk_tpu_torch.utils.matio import sample_reference_trajectory

F64 = jnp.float64
N = 256


@pytest.fixture(scope="module")
def setup():
    cfg = jveh.VehicleConfig(t_end=25 * 0.02)
    jmodel = jveh.make_model(cfg)
    _, Y, _, _, U = jveh.simulate(jax.random.key(5), cfg, dtype=F64)
    tmodel = convert.vehicle_model_from_arrays(dataclasses.asdict(cfg), convert.vehicle_arrays(jmodel))
    return jmodel, tmodel, np.asarray(Y), np.asarray(U)


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
def jax_step(setup):
    """The JAX sweep's initial carry, the first step's draws and the JAX
    full-trace result after that step."""
    jmodel, _, Y, U = setup
    lam = 0.999
    key = jax.random.key(7)
    key_scan, key_init = jax.random.split(key)
    init = JAPFKernel(jmodel.ssm, jmodel.gps, F64).init_particles(
        key_init, N, jnp.asarray(U[0]), jnp.asarray(jmodel.x0), jnp.asarray(jmodel.p0)
    )
    step_key = jax.random.split(key_scan, 1)[0]
    k, key_res = jax.random.split(step_key)
    k, key_state = jax.random.split(k)
    k, key_iv = jax.random.split(k)
    draws = StepDraws(
        _t(jax.random.uniform(key_res, dtype=F64)).reshape(1),
        _t(jax.random.normal(key_state, (2, N), F64)),
        _uvs(key_iv, N),
    )
    want = jax.jit(jbuild_apf(jmodel.ssm, jmodel.gps, N, lam, dtype=F64))(
        key, Y[:2], U[:2], jmodel.x0, jmodel.p0
    )
    return lam, init, draws, want


def _check_build_apf_step(setup, jax_step, **options):
    """The port's ``build_apf`` step from the JAX carry with the JAX
    draws, under the gather/draw ``options``, against the JAX traces."""
    _, tmodel, Y, U = setup
    lam, init, draws, want = jax_step
    apf = build_apf(tmodel.ssm, tmodel.gps, N, lam, dtype=torch.float64, device="cpu",
                    **options)
    lw0, state0, iv0, stats0 = init
    carry0 = convert.packed_carry_from_arrays(
        lw0, state0, iv0, [tuple(np.asarray(a) for a in st) for st in stats0],
        torch.float64, "cpu",
    )
    got = apf.run(carry0, _t(Y[:2]), _t(U[:2]), [draws])

    for name in ("states", "weights", "outputs", "log_likelihood", "ess"):
        _close(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(got.ancestors.numpy(), np.asarray(want.ancestors))
    for i in range(2):
        _close(got.int_vars[i], want.int_vars[i])
        for g, w in zip(got.stats_mean[i], want.stats_mean[i]):
            _close(g, w)
        for g, w in zip(got.final_stats[i], want.final_stats[i]):
            _close(g, w)
    return got, want


def test_build_apf_one_step_matches_jax_exactly(setup, jax_step):
    got, want = _check_build_apf_step(setup, jax_step)

    # the reference draw that seeds PGAS, with the JAX uniform
    key_traj = jax.random.key(8)
    want_ref = jsample_ref(key_traj, want)
    got_ref = sample_reference_trajectory(_t(jax.random.uniform(key_traj, dtype=F64)), got)
    _close(got_ref[0], want_ref[0])
    for g, w in zip(got_ref[1], want_ref[1]):
        _close(g, w)


@pytest.mark.parametrize("option", ["reuse_factor", "dedup_gather"])
def test_build_apf_one_step_matches_jax_exactly_opt_in(setup, jax_step, option):
    """``build_apf``'s opt-in gather/draw configurations: the same JAX
    step, exactly."""
    _check_build_apf_step(setup, jax_step, **{option: True})
