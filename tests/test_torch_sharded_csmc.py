"""The particle-sharded cSMC (``build_sharded_csmc``, ``build_csmc(mesh=)``,
``build_gibbs(shard_mesh=)``) on W ranks, on the CPU in float64: the
vehicle (two GPs, m = 20) and the toy (m = 40) at N = 64 over 11 and 9
steps, conditioned on their simulated trajectories.

W = 2 and 4: each rank a child process on gloo (``tests/_mesh_worker.py``:
a file store under the test's temporary directory, one torch thread, 120 s
per group of ranks, no JAX in the ranks); W = 1: in the test process.

(i) The sweep on 2 and 4 ranks, the full-width initial particles and draws
    sliced per rank, equals the sweep on one rank: the trajectory, the ESS,
    the gathered final weights, ancestors and traces, rtol 1e-12 of each
    leaf's largest value (the plain versions round differently at
    different batch widths on the CPU; ``tests/test_torch_sharded_apf.py``
    says by how much), the ancestors exactly.
(ii) The one-rank sharded sweep equals ``build_csmc`` without a mesh on
    the same draws, rtol 1e-12: the same step body on one device's
    operations (#2 and #4's gather there, the f64 slice, the ring and #3
    here).
(iii) The chunked sweep equals the unchunked one on 2 ranks, rtol 1e-12.
(iv) The argument checks.
(v) Collectives per step: the same on 2 and 4 ranks but for the ring's
    W - 1 rotations, and a fixed number for the backward draw (the port's
    counterpart of ``tests/test_scaling.py:69``).
(vi) ``build_gibbs(shard_mesh=)`` for 3 iterations on 2 ranks: every rank
    returns the same result, and a run resumed from rank 0's checkpoint
    after iteration 1 equals the uninterrupted run bit for bit.
(vii) Against the JAX ``build_sharded_csmc`` on ``particle_mesh(2)``:
    ``tests/test_torch_sharded_csmc_jax_vehicle.py`` and ``_toy.py``.

Every leaf is checked equal on every rank (``case_results``).
"""

import numpy as np
import pytest
import torch

import _mesh_worker
import _sharded_apf_cases as apf_cases
import _sharded_csmc_cases as cases
from bipk_tpu_torch.algorithms.csmc import build_csmc
from bipk_tpu_torch.algorithms.gibbs import build_gibbs
from bipk_tpu_torch.parallel.mesh import ParticleMesh, chain_mesh, particle_mesh
from bipk_tpu_torch.parallel.sharded_csmc import ShardedCSMC, build_sharded_csmc

N = 64
GIBBS_ITERATIONS = 3
# collectives per step and per backward draw on W ranks (rotations: W - 1)
PER_STEP = {"psum": 5, "pmax": 3, "pmin": 1, "all_gather_scalar": 2, "all_gather_last": 0}
PER_RESULT = {"psum": 2, "pmax": 1, "pmin": 1, "all_gather_scalar": 1, "all_gather_last": 1,
              "rotate": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setups():
    return {"vehicle": cases.vehicle(12), "toy": cases.toy(10)}


@pytest.fixture(scope="module")
def ranks(setups, tmp_path_factory):
    """Every multi-rank case, run once per W: ``{W: (cases, rank results)}``."""
    out = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"w{world}")
        run = {}
        for name, s in setups.items():
            run[name] = cases.inject_case(s, N)
            run[f"count_{name}"] = dict(run[name], kind="csmc_count")
            if world == 2:
                run[f"chunk_{name}"] = dict(run[name], chunk_size=16)
        if world == 2:
            run["gibbs"] = dict(setups["vehicle"].base, kind="csmc_gibbs", n=32,
                                iterations=GIBBS_ITERATIONS, seed=7,
                                checkpoint=str(tmp / "gibbs.ckpt"))
        out[world] = run, _mesh_worker.run_ranks(world, run, tmp)
    return out


def _one_rank(case):
    return _mesh_worker.run_csmc(case, particle_mesh(device="cpu"))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["vehicle", "toy"])
def test_w_ranks_equal_one_rank(ranks, name, world):
    run, results = ranks[world]
    got = apf_cases.case_results(results, name)
    want = _one_rank(run[name])
    assert all(np.all(np.isfinite(v)) for v in want.values())
    np.testing.assert_array_equal(got["ancestors"], want["ancestors"])
    apf_cases.assert_leaves_close(got, want, rtol=1e-12)


@pytest.mark.parametrize("name", ["vehicle", "toy"])
def test_one_rank_equals_build_csmc_without_a_mesh(setups, name):
    case = cases.inject_case(setups[name], N)
    sharded = _one_rank(case)
    single = _mesh_worker.run_csmc(dict(case, single=True), None)
    np.testing.assert_array_equal(sharded["ancestors"], single["ancestors"])
    apf_cases.assert_leaves_close(sharded, single, rtol=1e-12)
    # the pinned slot follows the reference at every step
    X, ivs, _ = case["ref"]
    np.testing.assert_array_equal(sharded["states"][:, :, -1], X)
    for i, iv in enumerate(ivs):
        np.testing.assert_array_equal(sharded[f"int_vars{i}"][:, :, -1], iv)


@pytest.mark.parametrize("name", ["vehicle", "toy"])
def test_chunked_equals_unchunked_on_two_ranks(ranks, name):
    _, results = ranks[2]
    want = apf_cases.case_results(results, name)
    got = apf_cases.case_results(results, f"chunk_{name}")
    np.testing.assert_array_equal(got["ancestors"], want["ancestors"])
    apf_cases.assert_leaves_close(got, want, rtol=1e-12)


@pytest.mark.parametrize("name", ["vehicle", "toy"])
def test_collectives_per_step_constant_in_mesh_size(ranks, setups, name):
    counts = {w: apf_cases.case_results(ranks[w][1], f"count_{name}") for w in (2, 4)}
    steps = setups[name].Y.shape[0] - 1
    for world, c in counts.items():
        for k, per in PER_STEP.items():
            np.testing.assert_array_equal(c[f"step/{k}"], np.full(steps, per), err_msg=k)
        np.testing.assert_array_equal(c["step/rotate"], np.full(steps, world - 1))
        assert {k: int(c[f"result/{k}"]) for k in PER_RESULT} == PER_RESULT
    # the same schedule on 2 and 4 ranks but for the ring's rotations
    differ = {k for k in counts[2] if not np.array_equal(counts[2][k], counts[4][k])}
    assert differ == {"step/rotate"}


def test_sharded_gibbs_on_two_ranks_and_its_resume(ranks):
    run, results = ranks[2]
    res = apf_cases.case_results(results, "gibbs")  # equal on both ranks
    full = {k[len("full/"):]: v for k, v in res.items() if k.startswith("full/")}
    resumed = {k[len("resumed/"):]: v for k, v in res.items() if k.startswith("resumed/")}
    apf_cases.assert_leaves_close(resumed, full, rtol=0.0)
    T = run["gibbs"]["Y"].shape[0]
    assert full["states"].shape == (T, GIBBS_ITERATIONS, 2)
    assert all(np.all(np.isfinite(v)) for v in full.values())
    # the first draw is the initial reference; the sweeps moved away from it
    np.testing.assert_array_equal(full["states"][:, 0], run["gibbs"]["ref"][0])
    assert not np.array_equal(full["states"][:, 1], full["states"][:, 0])


def test_argument_checks(setups):
    model = setups["vehicle"].tmodel
    cpu = torch.device("cpu")
    two, three = ParticleMesh(None, 0, 2, cpu), ParticleMesh(None, 0, 3, cpu)

    def build(**kw):
        return build_sharded_csmc(model.ssm, model.gps, 64, **kw)

    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        build(mesh=three)
    with pytest.raises(ValueError, match="per-shard particle count 32 not divisible by "
                                         "chunk_size 24"):
        build(mesh=two, chunk_size=24)
    with pytest.raises(ValueError, match="not the mesh's"):
        build(mesh=ParticleMesh(None, 0, 1, torch.device("meta")), device="cpu")
    # a chunk of n_loc or more runs unchunked; the reference's slot is the last rank's
    assert build(mesh=two, chunk_size=32).chunk_size is None
    sweep = build(mesh=two, chunk_size=16)
    assert sweep.n_loc == 32 and sweep.chunk_size == 16 and not sweep.holds_pinned
    assert build(mesh=ParticleMesh(None, 1, 2, cpu)).holds_pinned
    # build_csmc(mesh=) and build_gibbs(mesh= | shard_mesh=) build it; the
    # opt-in gather/draw kernels do not apply there
    one = particle_mesh(device="cpu")
    sweep = build_csmc(model.ssm, model.gps, 64, mesh=one, reuse_factor=True, dedup_gather=True)
    assert isinstance(sweep, ShardedCSMC)
    assert not (sweep.kern.reuse_factor or sweep.kern.dedup_gather)
    for kw in (dict(mesh=one), dict(shard_mesh=one)):
        assert isinstance(build_gibbs(model.ssm, model.gps, 64, 3, **kw).csmc, ShardedCSMC)
    with pytest.raises(ValueError, match="single-device"):
        build_csmc(model.ssm, model.gps, 64, mesh=one, rank1=True)
    with pytest.raises(ValueError, match="not both"):
        build_gibbs(model.ssm, model.gps, 64, 3, mesh=one, shard_mesh=one)
    for kw in (dict(mesh=one), dict(shard_mesh=one)):
        with pytest.raises(ValueError, match="chain_mesh"):
            build_gibbs(model.ssm, model.gps, 64, 3, n_chains=2, **kw)
    # chains go on a chain mesh, whose ranks each run whole chains
    chains = build_gibbs(model.ssm, model.gps, 64, 3, n_chains=2,
                         chain_mesh=chain_mesh(device="cpu"), device="cpu")
    assert not isinstance(chains.gibbs.csmc, ShardedCSMC) and chains.sharding.mesh.axis == "c"
    with pytest.raises(ValueError, match="chain_mesh"):
        build_gibbs(model.ssm, model.gps, 64, 3, n_chains=2, shard_mesh=one,
                    chain_mesh=chain_mesh(device="cpu"))
