"""The port's online APF sweep on the single-mass oscillator (m = 41, one
GP) against the JAX package's ``build_sharded_apf`` on one CPU device,
statistically: a seed-replicated two-sample z-test on the filtered means
(the RNG streams differ, so the estimators agree in distribution, not in
value).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipk_tpu.models import oscillator as josc
from bipk_tpu.parallel.mesh import particle_mesh
from bipk_tpu.parallel.sharded import build_sharded_apf as jbuild
from bipk_tpu_torch import convert
from bipk_tpu_torch.parallel.sharded import build_sharded_apf

LAM = 0.999
F64 = jnp.float64
T = 20  # steps of the sweeps


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


def test_sweep_matches_jax_statistically(setup):
    """Seed-replicated two-sample z-test on the time-averaged filtered
    position, velocity and spring/damper force of K sweeps of each
    implementation."""
    _, jmodel, tmodel, Y, U = setup
    N, K = 256, 6
    run = jax.jit(jbuild(jmodel.ssm, (jmodel.gp,), N, particle_mesh(1), LAM, dtype=F64))
    apf = build_sharded_apf(tmodel.ssm, tmodel.gps, N, forgetting_factor=LAM,
                            dtype=torch.float64, device="cpu")
    stats_j, stats_t = [], []
    for s in range(K):
        rj = run(jax.random.key(1000 + s), Y, U, jmodel.x0, jmodel.p0)
        rt = apf(torch.Generator().manual_seed(2000 + s), Y, U, tmodel.x0, tmodel.p0)
        for res, out in ((rj, stats_j), (rt, stats_t)):
            sm = np.asarray(res.state_mean)[3:]
            iv = np.asarray(res.int_var_mean[0])[3:, 0]
            assert np.all(np.isfinite(sm)) and np.all(np.isfinite(iv))
            out.append([sm[:, 0].mean(), sm[:, 1].mean(), iv.mean()])
        ess = rt.ess.numpy()
        assert np.all(ess >= 1.0 - 1e-9) and np.all(ess <= N + 1e-6)
    a, b = np.asarray(stats_j), np.asarray(stats_t)
    se = np.sqrt((a.var(0, ddof=1) + b.var(0, ddof=1)) / K)
    z = np.abs(a.mean(0) - b.mean(0)) / np.maximum(se, 1e-12)
    # 4 sigma with K = 6 replicates per side
    assert np.all(z < 4.0), (z, a.mean(0), b.mean(0), se)
