"""The chunked and windowed online APF sweep (``build_sharded_apf``'s
``chunk_size`` and ``window``) on the CPU in float64.

- Chunked against unchunked on one generator (vehicle and toy, N = 64,
  chunks of 16, 20 steps): equal to rtol 1e-12 (here bit for bit).
- Windowed (7 steps per piece over 24 observations: pieces of 7, 7, 7
  and 2 steps, as ``tests/test_sharded.py`` cuts them) against
  unwindowed, bit for bit, alone and with chunks.
- The JAX package's argument checks, no automatic chunking, and the
  launches per chunked step (chunks x #1 and #4 per GP, one #2).
- Against the JAX package's chunked sweep (``chunk_size=8`` on a
  one-device mesh, N = 32, 7 steps) with the JAX sweep's draws injected:
  its initial carry and, per step and chunk, the draws of its key
  discipline (``sharded.py:315-426``), concatenated over the chunks into
  one ``StepDraws``, which the port's chunked step slices back per chunk.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipk_tpu.algorithms.apf import APFKernel as JAPFKernel
from bipk_tpu.models import vehicle as jveh
from bipk_tpu.parallel.mesh import particle_mesh
from bipk_tpu.parallel.sharded import build_sharded_apf as jbuild
from bipk_tpu_torch import convert
from bipk_tpu_torch.models import toy as ttoy
from bipk_tpu_torch.models import vehicle as tveh
from bipk_tpu_torch.ops import cuda_kernels as ck
from bipk_tpu_torch.parallel.sharded import StepDraws, build_sharded_apf

F64 = torch.float64
LAM = 0.999


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes; one intra-op thread per
    worker keeps the torch side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vehicle(n_obs):
    cfg = tveh.VehicleConfig(t_end=n_obs * 0.02)
    model = tveh.make_model(cfg)
    _, Y, _, _, U = tveh.simulate(torch.Generator().manual_seed(1), cfg, dtype=F64,
                                  device="cpu")
    assert Y.shape[0] == n_obs
    return model, Y, U, LAM


def _toy(n_obs):
    cfg = ttoy.ToyConfig(n_steps=n_obs)
    model = ttoy.make_model(cfg)
    _, Y = ttoy.simulate(torch.Generator().manual_seed(1), cfg, dtype=F64, device="cpu")
    return model, Y, torch.zeros((n_obs, 0), dtype=F64), 1.0


MODELS = {"vehicle": _vehicle, "toy": _toy}


def _sweep(setup, n, seed=3, **kw):
    model, Y, U, lam = setup
    apf = build_sharded_apf(model.ssm, model.gps, n, forgetting_factor=lam, dtype=F64,
                            device="cpu", **kw)
    return apf(torch.Generator().manual_seed(seed), Y, U, model.x0, model.p0)


def _leaves(res):
    return {
        "state_mean": res.state_mean, "ess": res.ess, "final_state": res.final_state,
        "final_log_weights": res.final_log_weights,
        **{f"int_var_mean{i}": v for i, v in enumerate(res.int_var_mean)},
        **{f"stats_mean{i}.{k}": leaf for i, st in enumerate(res.stats_mean)
           for k, leaf in zip("T0 T1 T2 T3".split(), st)},
        **{f"final_stats{i}.{k}": leaf for i, st in enumerate(res.final_stats)
           for k, leaf in zip("T0 T1 T2 T3".split(), st)},
    }


@pytest.mark.parametrize("name", MODELS)
def test_chunked_equals_unchunked(name):
    setup = MODELS[name](21)
    want = _leaves(_sweep(setup, 64))
    got = _leaves(_sweep(setup, 64, chunk_size=16))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-12, atol=1e-14,
                                   err_msg=k)


@pytest.mark.parametrize("chunk_size", [None, 16], ids=["unchunked", "chunked"])
def test_windowed_equals_unwindowed_bit_for_bit(chunk_size):
    """24 observations, 23 steps: pieces of 7, 7, 7 and 2 steps; the
    moments come back as numpy, the final carry as tensors."""
    setup = _vehicle(24)
    want = _sweep(setup, 64, chunk_size=chunk_size)
    res = _sweep(setup, 64, chunk_size=chunk_size, window=7)
    assert isinstance(res.state_mean, np.ndarray) and isinstance(res.stats_mean[1].T1, np.ndarray)
    assert isinstance(res.final_state, torch.Tensor)
    assert res.state_mean.shape == (24, 2) and res.ess.shape == (24,)
    got, want = _leaves(res), _leaves(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k].numpy(), err_msg=k)


def test_window_longer_than_the_sweep():
    setup = _vehicle(5)
    want, got = _leaves(_sweep(setup, 32)), _leaves(_sweep(setup, 32, window=100))
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k].numpy(), err_msg=k)


def test_argument_checks():
    model = tveh.make_model(tveh.VehicleConfig(t_end=0.1))

    def build(n, **kw):
        return build_sharded_apf(model.ssm, model.gps, n, device="cpu", **kw)

    with pytest.raises(ValueError, match="local resampling scheme only"):
        build(64, chunk_size=16, resampling_scheme="exact")
    with pytest.raises(ValueError, match="per-shard particle count 64 not divisible by "
                                         "chunk_size 24"):
        build(64, chunk_size=24)
    with pytest.raises(ValueError, match="resampling_scheme must be"):
        build(64, resampling_scheme="global")
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        build(64, n_devices=3)
    with pytest.raises(ValueError, match="window must be positive"):
        build(64, window=0)
    for kw in (dict(n_devices=2), dict(resampling_scheme="exact")):
        with pytest.raises(NotImplementedError, match="Queue A item 8"):
            build(64, **kw)
    assert build(64, chunk_size=64).chunk_size is None  # a chunk of N or more: unchunked
    assert build(64, chunk_size=100).chunk_size is None
    chunked = build(64, chunk_size=16, reuse_factor=True, dedup_gather=True)
    assert chunked.chunk_size == 16  # no factor threaded, #4 draws, as JAX's chunked step
    assert not chunked.kern.reuse_factor and not chunked.kern.dedup_gather
    # no automatic chunking, at any size (no allocation at build time)
    assert build(1 << 24).chunk_size is None
    assert build(1 << 24, chunk_size=1 << 16).chunk_size == 1 << 16


def test_chunked_step_launches_per_chunk(monkeypatch):
    """Per step: one look-ahead (#1) and one gather/draw (#4) per chunk and
    GP, one resampling (#2) over all N."""
    setup = _vehicle(6)
    model, Y, U, lam = setup
    apf = build_sharded_apf(model.ssm, model.gps, 64, forgetting_factor=lam, dtype=F64,
                            device="cpu", chunk_size=16)
    calls = {"fp": [], "sys": [], "dug": []}

    def spy(key, fn):
        def wrapped(*args, **kw):
            calls[key].append(args[0].shape[-1] if key != "dug" else args[1].shape[0])
            return fn(*args, **kw)
        return wrapped

    apf.kern._factorize_project = spy("fp", apf.kern._factorize_project)
    apf.kern._systematic = spy("sys", apf.kern._systematic)
    monkeypatch.setattr(ck, "draw_update_gather_packed_blocks",
                        spy("dug", ck.draw_update_gather_packed_blocks))
    apf(torch.Generator().manual_seed(0), Y, U, model.x0, model.p0)
    steps = Y.shape[0] - 1
    assert calls["fp"] == [16] * (4 * 2 * steps)  # columns of S per launch
    assert calls["sys"] == [64] * steps
    assert calls["dug"] == [16] * (4 * 2 * steps)  # ancestors (N_out) per launch


def _arrays(model):
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


def test_chunked_sweep_matches_jax_chunked_sweep():
    """The JAX chunked sweep's draws, injected: ``key, key_init =
    split(key)``, the carry from ``init_particles(fold_in(key_init, 0))``,
    per step ``key_res, key_draws = split(step_key)``, the resampler's
    uniform from ``fold_in(key_res, 0)``, and per chunk ``c`` the process
    noise and the matrix-t uniforms from ``fold_in(fold_in(key_draws, 0),
    c)``; every moment and the final carry to rtol 1e-10."""
    N, chunk, T = 32, 8, 8
    f64 = jnp.float64
    cfg = jveh.VehicleConfig(t_end=T * 0.02)
    jmodel = jveh.make_model(cfg)
    _, Y, _, _, U = jveh.simulate(jax.random.key(5), cfg, dtype=f64)
    Y, U = np.asarray(Y), np.asarray(U)
    tmodel = convert.vehicle_model_from_arrays(dataclasses.asdict(cfg), _arrays(jmodel))
    key = jax.random.key(11)
    run = jax.jit(jbuild(jmodel.ssm, jmodel.gps, N, particle_mesh(1), LAM, dtype=f64,
                         chunk_size=chunk))
    want = run(key, Y, U, jmodel.x0, jmodel.p0)

    key_scan, key_init = jax.random.split(key)
    init = JAPFKernel(jmodel.ssm, jmodel.gps, f64).init_particles(
        jax.random.fold_in(key_init, 0), N, jnp.asarray(U[0]), jnp.asarray(jmodel.x0),
        jnp.asarray(jmodel.p0))

    def t(a):
        return torch.as_tensor(np.array(a), dtype=F64)

    def step_draws(step_key):
        key_res, key_draws = jax.random.split(step_key)
        key_base = jax.random.fold_in(key_draws, 0)
        zs, uvs = [], [([], []) for _ in jmodel.gps]
        for c in range(N // chunk):
            kc_state, kc_iv = jax.random.split(jax.random.fold_in(key_base, c))
            zs.append(jax.random.normal(kc_state, (2, chunk), f64))
            for i, k in enumerate(jax.random.split(kc_iv, len(jmodel.gps))):
                ku, kv = jax.random.split(k)
                uvs[i][0].append(jax.random.uniform(ku, (1, chunk), f64))
                uvs[i][1].append(jax.random.uniform(kv, (1, chunk), f64))
        return StepDraws(
            t(jax.random.uniform(jax.random.fold_in(key_res, 0), dtype=f64)).reshape(1),
            t(jnp.concatenate(zs, 1)),
            tuple((t(jnp.concatenate(u, 1)), t(jnp.concatenate(v, 1))) for u, v in uvs))

    apf = build_sharded_apf(tmodel.ssm, tmodel.gps, N, forgetting_factor=LAM, dtype=F64,
                            device="cpu", chunk_size=chunk)
    lw0, state0, iv0, stats0 = init
    carry = convert.packed_carry_from_arrays(
        lw0, state0, iv0, [tuple(np.asarray(a) for a in st) for st in stats0], F64, "cpu")
    moments = [apf.moments(torch.softmax(carry[0], 0), *carry[1:])]
    for s, step_key in enumerate(jax.random.split(key_scan, T - 1)):
        carry, mom = apf.step(carry, t(Y[s + 1]), t(U[s]), t(U[s + 1]), step_draws(step_key))
        moments.append(mom)
    got = _leaves(apf.finish(moments, carry))
    want = {k: np.asarray(v) for k, v in _leaves(want).items()}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-10, atol=1e-12, err_msg=k)
