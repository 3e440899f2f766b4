"""The port's online APF slice (vehicle model) against the JAX package's
``build_sharded_apf`` on one CPU device, statistically.

Both sweeps run on the same converted model and the same JAX-simulated
data, seeds replicated; a two-sample z-test on the filtered means (the RNG
streams differ, so the estimators agree in distribution, not in value).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipk_tpu.models import vehicle as jveh
from bipk_tpu.parallel.mesh import particle_mesh
from bipk_tpu.parallel.sharded import build_sharded_apf as jbuild
from bipk_tpu_torch import convert
from bipk_tpu_torch.parallel.sharded import build_sharded_apf

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


def test_slice_matches_jax_statistically(setup):
    """Seed-replicated two-sample z-test on the filtered means: the time-
    averaged state means and front-friction mean of K independent sweeps
    of each implementation."""
    cfg, jmodel, tmodel, Y, U = setup
    N, K = 512, 6
    run = jax.jit(jbuild(jmodel.ssm, jmodel.gps, N, particle_mesh(1), LAM,
                         dtype=jnp.float64))
    apf = build_sharded_apf(tmodel.ssm, tmodel.gps, N, forgetting_factor=LAM,
                            dtype=torch.float64, device="cpu")
    stats_j, stats_t = [], []
    for s in range(K):
        rj = run(jax.random.key(1000 + s), Y, U, jmodel.x0, jmodel.p0)
        rt = apf(torch.Generator().manual_seed(2000 + s), Y, U, tmodel.x0, tmodel.p0)
        for res, out in ((rj, stats_j), (rt, stats_t)):
            sm = np.asarray(res.state_mean)[5:]
            iv = np.asarray(res.int_var_mean[0])[5:, 0]
            assert np.all(np.isfinite(sm)) and np.all(np.isfinite(iv))
            out.append([sm[:, 0].mean(), sm[:, 1].mean(), iv.mean()])
        ess = rt.ess.numpy()
        assert np.all(ess >= 1.0 - 1e-9) and np.all(ess <= N + 1e-6)
    a, b = np.asarray(stats_j), np.asarray(stats_t)
    se = np.sqrt((a.var(0, ddof=1) + b.var(0, ddof=1)) / K)
    z = np.abs(a.mean(0) - b.mean(0)) / np.maximum(se, 1e-12)
    # 4 sigma with K = 6 replicates per side
    assert np.all(z < 4.0), (z, a.mean(0), b.mean(0), se)
