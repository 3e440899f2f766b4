"""The chain mesh (``chain_mesh``, ``chain_sharding``,
``build_gibbs(n_chains=C, chain_mesh=)``) on W ranks, on the CPU in
float64: the toy (m = 40) at 32 particles over 7 steps, C = 4 chains, 3
sweeps.

W = 2 and 4: each rank a child process on gloo (``tests/_mesh_worker.py``:
a file store under the test's temporary directory, one torch thread, 120 s
per group of ranks, no JAX in the ranks); one device: ``build_gibbs(
n_chains=4)`` without a mesh, in the test process on one torch thread.

(i) Every rank returns all C chains, every leaf bit for bit the chains
    on one device, from a shared and (W = 2) from a per-chain initial
    reference.
(ii) No collective inside a sweep: the mesh's collectives counted per
    sweep are all zero, and the one gather at the end makes one
    ``all_gather_last`` per leaf of the result.
(iii) A checkpoint written on 2 ranks after sweep 1 resumes bit for bit on
    2 ranks and on one device.
(iv) The refusals of the JAX ``build_gibbs`` (``gibbs.py:111-126``) raise
    the same exception types here.
"""

import shutil

import jax
import numpy as np
import pytest
import torch

import _mesh_worker
import _sharded_apf_cases as apf_cases
import _sharded_csmc_cases as cases
from bipk_tpu.algorithms.gibbs import build_gibbs as jbuild_gibbs
from bipk_tpu.parallel import mesh as jmesh
from bipk_tpu_torch.algorithms.gibbs import ParallelGibbs, build_gibbs
from bipk_tpu_torch.parallel.mesh import (CHAIN_AXIS, ChainSharding, ParticleMesh, chain_mesh,
                                          chain_sharding, particle_mesh)

N, N_OBS, CHAINS, ITERATIONS = 32, 8, 4, 4
COLLECTIVES = _mesh_worker.COLLECTIVES


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    return cases.toy(N_OBS)


def _case(setup, checkpoint, per_chain=False):
    case = dict(setup.base, kind="chain_gibbs", n=N, chains=CHAINS, iterations=ITERATIONS,
                seed=11, checkpoint=str(checkpoint))
    if per_chain:  # chain c starts from the reference scaled by 1 + c / 10
        X, ivs, _ = setup.base["ref"]
        scale = 1.0 + 0.1 * np.arange(CHAINS)[:, None, None]
        case["chain_ref"] = (scale * X, [scale * iv for iv in ivs])
    return case


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """``{W: (cases, rank results)}``, one group of ranks per W."""
    out = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"w{world}")
        run = {"shared": _case(setup, tmp / "shared.ckpt")}
        if world == 2:
            run["per_chain"] = _case(setup, tmp / "per_chain.ckpt", per_chain=True)
        out[world] = run, _mesh_worker.run_ranks(world, run, tmp)
    return out


def _leaves(results, name, prefix):
    res = apf_cases.case_results(results, name)  # equal on every rank
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def _one_device(case, **kw):
    return {k: np.asarray(v) for k, v in _mesh_worker.chain_gibbs(
        case, None, case["iterations"], **kw).items()}


@pytest.mark.parametrize("world", [2, 4])
def test_chains_on_w_ranks_equal_the_chains_on_one_device(ranks, world):
    run, results = ranks[world]
    got = _leaves(results, "shared", "full/")
    want = _one_device(run["shared"])
    assert want["states"].shape == (CHAINS, N_OBS, ITERATIONS, 1)
    assert all(np.all(np.isfinite(v)) for v in want.values())
    apf_cases.assert_leaves_close(got, want, rtol=0.0)
    # the chains differ: each runs on its own generator
    assert not np.array_equal(want["states"][0, :, -1], want["states"][1, :, -1])


def test_per_chain_reference_on_two_ranks(ranks):
    run, results = ranks[2]
    got = _leaves(results, "per_chain", "full/")
    apf_cases.assert_leaves_close(got, _one_device(run["per_chain"]), rtol=0.0)
    X, _ = run["per_chain"]["chain_ref"]
    np.testing.assert_array_equal(got["states"][:, :, 0], X)  # the first draw is each reference


@pytest.mark.parametrize("world", [2, 4])
def test_no_collective_inside_a_sweep(ranks, world):
    run, results = ranks[world]
    sweeps = _leaves(results, "shared", "sweep/")
    end = _leaves(results, "shared", "end/")
    for name in COLLECTIVES:
        np.testing.assert_array_equal(sweeps[name], np.zeros(ITERATIONS - 1), err_msg=name)
    n_leaves = len(_leaves(results, "shared", "full/"))
    assert {k: int(v) for k, v in end.items()} == {
        **dict.fromkeys(COLLECTIVES, 0), "all_gather_last": n_leaves}


def test_checkpoint_from_two_ranks_resumes_on_two_ranks_and_on_one_device(ranks, tmp_path):
    run, results = ranks[2]
    full = _leaves(results, "shared", "full/")
    apf_cases.assert_leaves_close(_leaves(results, "shared", "resumed/"), full, rtol=0.0)
    path = tmp_path / "one_device.ckpt"
    shutil.copy(run["shared"]["checkpoint"] + ".sweep1", path)
    resumed = _one_device(run["shared"], checkpoint_path=str(path), checkpoint_every=1)
    apf_cases.assert_leaves_close(resumed, full, rtol=0.0)


def test_chain_sharding_blocks():
    cpu = torch.device("cpu")
    for rank in range(4):
        sh = chain_sharding(ParticleMesh(None, rank, 4, cpu, CHAIN_AXIS))
        assert isinstance(sh, ChainSharding)
        assert sh.block(8) == slice(2 * rank, 2 * rank + 2)
        assert sh.keep(list(range(8))) == [2 * rank, 2 * rank + 1]
        with pytest.raises(ValueError, match="not divisible"):
            sh.block(6)
    one = chain_mesh(device="cpu")
    assert (one.size, one.rank, one.group, one.axis) == (1, 0, None, CHAIN_AXIS)
    x = torch.arange(12.0).reshape(3, 4)
    assert torch.equal(chain_sharding(one).gather(x), x)
    assert particle_mesh(device="cpu").axis != CHAIN_AXIS
    with pytest.raises(ValueError, match="needs a process group"):
        chain_mesh(2, device="cpu")


def test_argument_checks_raise_as_jax_does(setup):
    """Each call the JAX ``build_gibbs`` refuses raises the same exception
    type in the port; the calls it accepts build here."""
    model = setup.tmodel
    cpu = torch.device("cpu")
    two = ParticleMesh(None, 0, 2, cpu, CHAIN_AXIS)
    jtwo = jmesh.chain_mesh(2)
    jpart = jmesh.particle_mesh(2)
    refused = [  # (port keywords, JAX keywords)
        (dict(chain_mesh=two), dict(chain_mesh=jtwo)),
        (dict(n_chains=4, mesh=particle_mesh(device="cpu")), dict(n_chains=4, mesh=jpart)),
        (dict(n_chains=4, shard_mesh=particle_mesh(device="cpu")),
         dict(n_chains=4, shard_mesh=jpart)),
        (dict(n_chains=1, chain_mesh=two), dict(n_chains=1, chain_mesh=jtwo)),
        (dict(n_chains=3, chain_mesh=two), dict(n_chains=3, chain_mesh=jtwo)),
    ]
    for kw, jkw in refused:
        with pytest.raises(Exception) as jax_error:
            jbuild_gibbs(setup.jmodel.ssm, setup.jgps, N, 3, **jkw)
        with pytest.raises(jax_error.type):
            build_gibbs(model.ssm, model.gps, N, 3, device="cpu", **kw)
    built = build_gibbs(model.ssm, model.gps, N, 3, n_chains=4, chain_mesh=two, device="cpu")
    assert isinstance(built, ParallelGibbs) and built.sharding.mesh is two
    jbuild_gibbs(setup.jmodel.ssm, setup.jgps, N, 3, n_chains=4, chain_mesh=jtwo)
    with pytest.raises(ValueError, match="not the mesh's"):
        build_gibbs(model.ssm, model.gps, N, 3, n_chains=4, chain_mesh=two,
                    device=torch.device("meta"))
    assert len(jax.devices()) >= 2
