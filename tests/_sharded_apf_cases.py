"""Cases of the sharded online APF's CPU tests (``tests/test_torch_sharded_
apf*.py``): the models and their data from the JAX package, the initial
carries and the draws, as the plain data (numpy and Python) that the gloo
ranks of ``tests/_mesh_worker.py`` read. Imports JAX; the ranks never
import this module."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from bipk_tpu.algorithms.apf import APFKernel as JAPFKernel
from bipk_tpu.models import toy as jtoy
from bipk_tpu.models import vehicle as jveh
from bipk_tpu.parallel.mesh import particle_mesh as jparticle_mesh
from bipk_tpu.parallel.sharded import build_sharded_apf as jbuild
import _mesh_worker
from _mesh_worker import result_leaves
from bipk_tpu_torch import convert

F64 = jnp.float64


@dataclasses.dataclass
class Setup:
    """One model at a test size: the JAX model, its data and the case
    fields every rank needs to rebuild the port's model."""

    name: str
    jmodel: object
    jgps: tuple
    Y: np.ndarray
    U: np.ndarray
    lam: float
    base: dict  # model, config, arrays, Y, U, lam

    @property
    def tmodel(self):
        make = {"vehicle": convert.vehicle_model_from_arrays,
                "toy": convert.toy_model_from_arrays}[self.name]
        return make(self.base["config"], self.base["arrays"])


def vehicle(n_obs: int) -> Setup:
    cfg = jveh.VehicleConfig(t_end=n_obs * 0.02)
    jmodel = jveh.make_model(cfg)
    _, Y, _, _, U = jveh.simulate(jax.random.key(5), cfg, dtype=F64)
    Y, U = np.asarray(Y), np.asarray(U)
    assert Y.shape[0] == n_obs
    base = dict(model="vehicle", config=dataclasses.asdict(cfg),
                arrays=convert.vehicle_arrays(jmodel), Y=Y, U=U, lam=0.999)
    return Setup("vehicle", jmodel, tuple(jmodel.gps), Y, U, 0.999, base)


def toy(n_obs: int) -> Setup:
    cfg = jtoy.ToyConfig(n_steps=n_obs)
    jmodel = jtoy.make_model(cfg)
    _, Y = jtoy.simulate(jax.random.key(5), cfg, dtype=F64)
    Y, U = np.asarray(Y), np.zeros((n_obs, 0))
    base = dict(model="toy", config=dataclasses.asdict(cfg),
                arrays=convert.toy_arrays(jmodel), Y=Y, U=U, lam=1.0)
    return Setup("toy", jmodel, (jmodel.gp,), Y, U, 1.0, base)


def _init(setup: Setup, key, n):
    """The JAX kernel's initial carry of ``n`` particles as numpy:
    ``(log_weights, state, int_vars, stats)``, batch-last."""
    kern = JAPFKernel(setup.jmodel.ssm, setup.jgps, F64)
    init = jax.jit(kern.init_particles, static_argnums=1)
    lw, state, ivs, stats = init(key, n, jnp.asarray(setup.U[0]),
                                 jnp.asarray(setup.jmodel.x0), jnp.asarray(setup.jmodel.p0))
    return (np.asarray(lw), np.asarray(state), [np.asarray(iv) for iv in ivs],
            [tuple(np.asarray(a) for a in st) for st in stats])


def _concat(parts):
    """Per-shard carries (or draws) -> one, concatenated along the last axis."""
    first = parts[0]
    if isinstance(first, np.ndarray):
        return np.concatenate(parts, -1)
    return type(first)(_concat(list(p)) for p in zip(*parts))


def inject_case(setup: Setup, scheme: str, n: int, world: int = 1, seed: int = 0) -> dict:
    """A sweep of ``n`` particles with a full-width initial carry and draws
    from numpy (``seed``), sliced per rank by the ranks; the resampling
    uniform of a step is the same for every rank (the exact scheme's
    rule)."""
    rng = np.random.default_rng(seed)
    steps = setup.Y.shape[0] - 1
    dx = setup.jmodel.x0.shape[0]
    deterministic = setup.jmodel.ssm.is_deterministic
    u_res = np.repeat(rng.uniform(size=(steps, 1)), world, 1)
    draws = dict(
        u_res=u_res,
        z=None if deterministic else rng.standard_normal((steps, dx, n)),
        uvs=[(rng.uniform(size=(steps, gp.out_dim, n)), rng.uniform(size=(steps, gp.out_dim, n)))
             for gp in setup.jgps])
    return dict(setup.base, kind="inject", n=n, scheme=scheme,
                carry=_init(setup, jax.random.key(seed + 100), n), draws=draws)


def jax_case(setup: Setup, scheme: str, n: int, world: int, key):
    """The JAX package's ``build_sharded_apf`` on ``particle_mesh(world)``
    (its result, as numpy leaves) and the port's case with the JAX sweep's
    draws: the initial carry of shard ``s`` from ``fold_in(key_init, s)``,
    and per step (``key_res, key_draws = split(step_key)``) the resampling
    uniform from ``key_res`` (exact) or ``fold_in(key_res, s)`` (local), the
    process noise and the matrix-t uniforms from ``split(fold_in(key_draws,
    s))`` (``sharded.py:242-256, 429-447``)."""
    jm, n_loc = setup.jmodel, n // world
    run = jax.jit(jbuild(jm.ssm, setup.jgps, n, jparticle_mesh(world), setup.lam,
                         dtype=F64, resampling_scheme=scheme))
    res = run(key, setup.Y, setup.U, jm.x0, jm.p0)
    key_scan, key_init = jax.random.split(key)
    carry = _concat([_init(setup, jax.random.fold_in(key_init, s), n_loc) for s in range(world)])
    dx, outs = jm.x0.shape[0], [gp.out_dim for gp in setup.jgps]

    @jax.jit
    def step_draws(step_key):
        key_res, key_draws = jax.random.split(step_key)
        u, z, uv = [], [], [([], []) for _ in outs]
        for s in range(world):
            u.append(jax.random.uniform(key_res if scheme == "exact"
                                        else jax.random.fold_in(key_res, s), dtype=F64))
            key_state, key_iv = jax.random.split(jax.random.fold_in(key_draws, s))
            z.append(jax.random.normal(key_state, (dx, n_loc), F64))
            for i, k in enumerate(jax.random.split(key_iv, len(outs))):
                ku, kv = jax.random.split(k)
                uv[i][0].append(jax.random.uniform(ku, (outs[i], n_loc), F64))
                uv[i][1].append(jax.random.uniform(kv, (outs[i], n_loc), F64))
        cat = functools.partial(jnp.concatenate, axis=-1)
        return jnp.stack(u), cat(z), [(cat(a), cat(b)) for a, b in uv]

    steps = [step_draws(k) for k in jax.random.split(key_scan, setup.Y.shape[0] - 1)]
    draws = dict(u_res=np.stack([np.asarray(d[0]) for d in steps]),
                 z=None if jm.ssm.is_deterministic else np.stack([np.asarray(d[1]) for d in steps]),
                 uvs=[tuple(np.stack([np.asarray(d[2][i][j]) for d in steps]) for j in range(2))
                      for i in range(len(outs))])
    case = dict(setup.base, kind="inject", n=n, scheme=scheme, carry=carry, draws=draws)
    return case, result_leaves(res)


def case_results(rank_results: list, name: str) -> dict:
    """One case's results, equal on every rank (checked), by leaf name."""
    prefix = f"{name}/"
    first = {k[len(prefix):]: v for k, v in rank_results[0].items() if k.startswith(prefix)}
    assert first, name
    for r, res in enumerate(rank_results[1:], 1):
        for k, v in first.items():
            np.testing.assert_array_equal(res[prefix + k], v, err_msg=f"rank {r}: {name} {k}")
    return first


def assert_leaves_close(got: dict, want: dict, rtol: float):
    """Every leaf within ``rtol`` of its largest value (``rtol=0``: bit for
    bit): where a sweep's many small values pass through cancellations, a
    relative error per entry would measure those, not the sweep."""
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    for k in want:
        scale = float(np.abs(want[k]).max()) if want[k].size else 0.0
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=rtol * scale, err_msg=k)


def jax_runs(scheme: str, tmp_dir) -> dict:
    """Item (iii) of ``tests/test_torch_sharded_apf.py`` for one scheme:
    the vehicle and the toy at N = 32 on 2 gloo ranks with the JAX sweep's
    draws, and the JAX sweep on ``particle_mesh(2)``: ``{model: (port's
    leaves, JAX's leaves)}``."""
    run, want = {}, {}
    for name, setup in (("vehicle", vehicle(12)), ("toy", toy(10))):
        run[name], want[name] = jax_case(setup, scheme, 32, 2, jax.random.key(11))
    results = _mesh_worker.run_ranks(2, run, tmp_dir)
    return {name: (case_results(results, name), want[name]) for name in run}
