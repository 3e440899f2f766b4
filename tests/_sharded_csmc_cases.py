"""Cases of the sharded cSMC's CPU tests (``tests/test_torch_sharded_
csmc*.py``): the vehicle and the toy with a reference trajectory, their
unpinned initial particles and the draws of a sweep, as the plain data
(numpy and Python) that the gloo ranks of ``tests/_mesh_worker.py`` read;
and the JAX package's ``build_sharded_csmc`` on ``particle_mesh(W)`` with
the port's case on its draws. Imports JAX; the ranks never import this
module."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

import _sharded_apf_cases as apf_cases
from bipk_tpu.algorithms.gibbs import summed_reference_stats as jsummed
from bipk_tpu.models import toy as jtoy
from bipk_tpu.models import vehicle as jveh
from bipk_tpu.ops import mniw as jmniw
from bipk_tpu.parallel.mesh import particle_mesh as jparticle_mesh
from bipk_tpu.parallel.sharded_csmc import build_sharded_csmc as jbuild

F64 = jnp.float64


def _with_reference(setup: apf_cases.Setup, X, ivs) -> apf_cases.Setup:
    """``setup`` whose base case carries the reference ``(state (T, dx),
    interface variables (each (T, n_i)), summed statistics per GP)``, the
    summed statistics the JAX package's."""
    summed = jsummed(setup.jgps, jnp.asarray(X), tuple(map(jnp.asarray, ivs)),
                     jnp.asarray(setup.U), F64)
    ref = (np.asarray(X), [np.asarray(iv) for iv in ivs],
           [tuple(np.asarray(a) for a in st) for st in summed])
    setup.base = dict(setup.base, ref=ref)
    return setup


def vehicle(n_obs: int) -> apf_cases.Setup:
    """The vehicle of ``_sharded_apf_cases`` with its simulated trajectory
    and frictions as the reference."""
    setup = apf_cases.vehicle(n_obs)
    cfg = jveh.VehicleConfig(t_end=n_obs * 0.02)
    X, _, mu_f, mu_r, _ = jveh.simulate(jax.random.key(5), cfg, dtype=F64)
    return _with_reference(setup, X, (np.asarray(mu_f)[:, None], np.asarray(mu_r)[:, None]))


def toy(n_obs: int) -> apf_cases.Setup:
    """The toy of ``_sharded_apf_cases`` with its simulated states as the
    reference; the interface variable at t is the next state (the true
    function at the last)."""
    setup = apf_cases.toy(n_obs)
    X, _ = jtoy.simulate(jax.random.key(5), jtoy.ToyConfig(n_steps=n_obs), dtype=F64)
    X = np.asarray(X)
    return _with_reference(setup, X, (np.concatenate([X[1:], np.asarray(jtoy.f_true(X[-1:]))]),))


def inject_case(setup: apf_cases.Setup, n: int, seed: int = 0, **extra) -> dict:
    """A sweep of ``n`` particles from full-width unpinned initial
    particles and draws from numpy (``seed``), sliced per rank by the
    ranks; the uniforms every rank shares (resampling, reference ancestor,
    final trajectory) are one per step (one per sweep). ``extra``: more
    case fields (``chunk_size``, ``single``, ``kind``)."""
    rng = np.random.default_rng(seed)
    steps = setup.Y.shape[0] - 1
    dx = setup.jmodel.x0.shape[0]
    draws = dict(
        u_res=rng.uniform(size=steps), u_ref=rng.uniform(size=steps),
        z=None if setup.jmodel.ssm.is_deterministic else rng.standard_normal((steps, dx, n)),
        uvs=[(rng.uniform(size=(steps, gp.out_dim, n)), rng.uniform(size=(steps, gp.out_dim, n)))
             for gp in setup.jgps])
    return dict(setup.base, kind="csmc", n=n, u_final=rng.uniform(),
                particles=apf_cases._init(setup, jax.random.key(seed + 100), n), draws=draws,
                **extra)


def _spy_ancestors(captured):
    """A stand-in for ``jax.lax.scan`` that, for the sharded cSMC's step,
    hands each shard's emitted ancestors to ``captured[shard]``."""
    from bipk_tpu.parallel.mesh import PARTICLE_AXIS

    real_scan = jax.lax.scan

    def spy(f, init, xs, *args, **kwargs):
        out = real_scan(f, init, xs, *args, **kwargs)
        if getattr(f, "__name__", "") in ("step", "step_chunked"):
            jax.debug.callback(lambda s, a: captured.__setitem__(int(s), np.asarray(a)),
                               jax.lax.axis_index(PARTICLE_AXIS), out[1][2])
        return out

    return spy


def jax_case(setup: apf_cases.Setup, n: int, world: int, key, monkeypatch):
    """The JAX package's ``build_sharded_csmc`` on ``particle_mesh(world)``
    (its result and emitted ancestors, as numpy leaves) and the port's
    case with the JAX sweep's draws (``sharded_csmc.py:161-167, 228-231,
    508, 535-537``): ``key, key_final = split(key)``; in the sweep ``key,
    key_init = split(key)``, shard ``s``'s particles from ``fold_in(key_init,
    s)``, one key per step from ``split(key, T)``, and per step ``key_res,
    key_ref, key_draws = split(step_key, 3)``: the resampling and the
    reference ancestor's uniforms from ``key_res`` and ``key_ref``, the
    process noise and the matrix-t uniforms of shard ``s`` from
    ``split(fold_in(key_draws, s))`` (``apf.py:151-155, 412-425``); the final
    trajectory's uniform from ``key_final``."""
    jm, n_loc = setup.jmodel, n // world
    X, ivs, summed = setup.base["ref"]
    captured = {}
    monkeypatch.setattr(jax.lax, "scan", _spy_ancestors(captured))
    run = jax.jit(jbuild(jm.ssm, setup.jgps, n, jparticle_mesh(world), dtype=F64))
    res = run(key, setup.Y, setup.U, jm.x0, jm.p0, X, tuple(ivs),
              tuple(jmniw.MNIW(*st) for st in summed))
    jax.block_until_ready(res)
    monkeypatch.undo()
    assert sorted(captured) == list(range(world)), sorted(captured)

    key_sweep, key_final = jax.random.split(key)
    key_scan, key_init = jax.random.split(key_sweep)
    particles = apf_cases._concat([apf_cases._init(setup, jax.random.fold_in(key_init, s), n_loc)
                                   for s in range(world)])
    dx, outs = jm.x0.shape[0], [gp.out_dim for gp in setup.jgps]

    @jax.jit
    def step_draws(step_key):
        key_res, key_ref, key_draws = jax.random.split(step_key, 3)
        z, uv = [], [([], []) for _ in outs]
        for s in range(world):
            key_state, key_iv = jax.random.split(jax.random.fold_in(key_draws, s))
            z.append(jax.random.normal(key_state, (dx, n_loc), F64))
            for i, k in enumerate(jax.random.split(key_iv, len(outs))):
                ku, kv = jax.random.split(k)
                uv[i][0].append(jax.random.uniform(ku, (outs[i], n_loc), F64))
                uv[i][1].append(jax.random.uniform(kv, (outs[i], n_loc), F64))
        cat = functools.partial(jnp.concatenate, axis=-1)
        return (jax.random.uniform(key_res, dtype=F64), jax.random.uniform(key_ref, dtype=F64),
                cat(z), [(cat(a), cat(b)) for a, b in uv])

    steps = [step_draws(k) for k in jax.random.split(key_scan, setup.Y.shape[0])[:-1]]
    draws = dict(
        u_res=np.array([float(d[0]) for d in steps]), u_ref=np.array([float(d[1]) for d in steps]),
        z=None if jm.ssm.is_deterministic else np.stack([np.asarray(d[2]) for d in steps]),
        uvs=[tuple(np.stack([np.asarray(d[3][i][j]) for d in steps]) for j in range(2))
             for i in range(len(outs))])
    case = dict(setup.base, kind="csmc", n=n, particles=particles, draws=draws,
                u_final=float(jax.random.uniform(key_final, dtype=F64)))
    want = {"state_traj": np.asarray(res.state_traj), "ess": np.asarray(res.ess),
            "log_weights": np.asarray(res.log_weights),
            "ancestors": np.concatenate([captured[s] for s in range(world)], -1)}
    want.update({f"int_var_traj{i}": np.asarray(v) for i, v in enumerate(res.int_var_traj)})
    return case, want


def jax_run(setup: apf_cases.Setup, tmp_dir, monkeypatch) -> tuple:
    """The JAX comparison for one model at N = 32 on 2 gloo ranks:
    ``(port's leaves, JAX's leaves)``, the port's restricted to the JAX
    result's."""
    case, want = jax_case(setup, 32, 2, jax.random.key(11), monkeypatch)
    import _mesh_worker

    got = apf_cases.case_results(_mesh_worker.run_ranks(2, {"jax": case}, tmp_dir), "jax")
    return {k: got[k] for k in want}, want
