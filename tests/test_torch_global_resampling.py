"""Exact global resampling on a particle mesh (``bipk_tpu_torch.parallel.
global_resampling``) on the CPU in float64, against the JAX package's
``bipk_tpu.parallel.global_resampling`` under ``shard_map`` on
``particle_mesh(W)`` (the test process's virtual CPU devices).

W = 2 and 4: each rank a child process on gloo (``tests/_mesh_worker.py``:
a file store under the test's temporary directory, one torch thread, 120 s
per group of ranks, no JAX in the ranks); W = 1: a one-rank mesh without a
process group, in the test process. As in ``tests/test_sharded.py:111-178``,
at n = 128 over seeds 0-3 (weights ``softmax(2 z)``, the uniform
``jax.random.uniform(key)`` that the JAX functions draw from the key
they are given):

- ``global_systematic_slice`` equals JAX's and the single-device
  ``resampling.systematic`` of both packages, exactly;
- ``global_categorical`` equals JAX's, exactly;
- ``ring_redistribute`` of 1-, 2- and 3-D payloads by arbitrary (unsorted)
  global ancestors equals a global gather, exactly;

and every rank holds the same gathered results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import _mesh_worker
from bipk_tpu.ops import resampling as jres
from bipk_tpu.parallel import global_resampling as jgr
from bipk_tpu.parallel.mesh import PARTICLE_AXIS
from bipk_tpu.parallel.mesh import particle_mesh as jparticle_mesh
from bipk_tpu_torch.ops import resampling as tres
from bipk_tpu_torch.parallel.mesh import particle_mesh

N = 128
SEEDS = (0, 1, 2, 3)
WORLDS = (1, 2, 4)


def _case():
    w, u, keys = [], [], []
    for seed in SEEDS:
        key_w, key_r = jax.random.split(jax.random.key(seed))
        w.append(np.asarray(jax.nn.softmax(2.0 * jax.random.normal(key_w, (N,), jnp.float64))))
        u.append(np.asarray(jax.random.uniform(key_r, dtype=jnp.float64)))
        keys.append(key_r)
    k1, k2, k3, k4 = jax.random.split(jax.random.key(11), 4)
    payloads = [np.asarray(jax.random.normal(k, shape, jnp.float64))
                for k, shape in ((k1, (N,)), (k2, (5, N)), (k3, (3, 4, N)))]
    ancestors = np.asarray(jax.random.randint(k4, (N,), 0, N, dtype=jnp.int32))
    case = dict(kind="resampling", n=N, w=w, u=u, payloads=payloads, ancestors=ancestors)
    return case, keys


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The case, the JAX keys, and per W the ranks' results (W = 1: one)."""
    case, keys = _case()
    results = {1: [_mesh_worker.run_resampling(case, particle_mesh(device="cpu"))]}
    for world in WORLDS[1:]:
        results[world] = _mesh_worker.run_ranks(
            world, {"resampling": case}, tmp_path_factory.mktemp(f"w{world}"))
        results[world] = [{k.split("/", 1)[1]: v for k, v in r.items()}
                          for r in results[world]]
    return case, keys, results


def _jax_sharded(fn, world, *args):
    mesh = jparticle_mesh(world)
    sharded = shard_map(lambda k, wl: fn(k, wl, PARTICLE_AXIS, world), mesh=mesh,
                        in_specs=(P(), P(PARTICLE_AXIS)), out_specs=P(), check_vma=False)
    return np.asarray(jax.jit(sharded)(*args))


def _replicated(results, name):
    """The result every rank holds, checked equal on all of them."""
    first = results[0][name]
    for r, res in enumerate(results[1:], 1):
        np.testing.assert_array_equal(res[name], first, err_msg=f"rank {r}: {name}")
    return first


@pytest.mark.parametrize("world", WORLDS)
def test_global_systematic_slice_equals_jax_and_the_single_device_resampler(setup, world):
    case, keys, results = setup
    jmesh = jparticle_mesh(world)
    jfn = jax.jit(shard_map(
        lambda k, wl: jgr.global_systematic_slice(k, wl, PARTICLE_AXIS, world), mesh=jmesh,
        in_specs=(P(), P(PARTICLE_AXIS)), out_specs=P(PARTICLE_AXIS), check_vma=False))
    for seed, key_r in zip(SEEDS, keys):
        got = _replicated(results[world], f"systematic{seed}")
        w, u = case["w"][seed], case["u"][seed]
        want = np.asarray(jfn(key_r, jnp.asarray(w)))
        assert got.dtype == np.int32 and got.shape == (N,)
        np.testing.assert_array_equal(got, want, err_msg=f"JAX sharded, seed {seed}")
        np.testing.assert_array_equal(got, np.asarray(jres.systematic(key_r, jnp.asarray(w))),
                                      err_msg=f"JAX single device, seed {seed}")
        np.testing.assert_array_equal(
            got, tres.systematic(torch.tensor(w), torch.tensor(u)).numpy(),
            err_msg=f"port single device, seed {seed}")


@pytest.mark.parametrize("world", WORLDS)
def test_global_categorical_equals_jax(setup, world):
    case, keys, results = setup
    for seed, key_r in zip(SEEDS, keys):
        got = _replicated(results[world], f"categorical{seed}")
        want = _jax_sharded(jgr.global_categorical, world, key_r, jnp.asarray(case["w"][seed]))
        assert got.shape == () and got.dtype == np.int32
        assert int(got) == int(want), (seed, got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_redistribute_equals_a_global_gather(setup, world):
    case, _, results = setup
    anc = case["ancestors"]
    assert not np.all(np.diff(anc) >= 0)  # unsorted, and ancestors on every rank
    for i, p in enumerate(case["payloads"]):
        got = _replicated(results[world], f"ring{i}")
        assert got.shape == p.shape
        np.testing.assert_array_equal(got, p[..., anc], err_msg=f"payload {i}")
