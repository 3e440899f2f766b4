"""The particle-sharded online APF (``build_sharded_apf(..., mesh=...)``) on
W ranks, on the CPU in float64: the vehicle (two GPs, m = 20) and the toy
(m = 40) at N = 64 (32 against JAX, 128 in the z-test) over 9-29 steps.

W = 2 and 4: each rank a child process on gloo (``tests/_mesh_worker.py``:
a file store under the test's temporary directory, one torch thread, 120 s
per group of ranks, no JAX in the ranks); W = 1: in the test process.

(i) The exact scheme on 2 and 4 ranks, the full-width initial carry and
    draws sliced per rank, equals the exact scheme on one rank, rtol 1e-12.
(ii) The exact and the local schemes on one rank on the same draws agree,
    rtol 1e-12.
(iii) Local and exact on 2 ranks equal the JAX ``build_sharded_apf`` on
    ``particle_mesh(2)`` with the JAX sweep's draws injected, rtol 1e-10:
    ``tests/test_torch_sharded_apf_jax_local.py`` and ``_exact.py``.
(iv) Local on 2 ranks against one rank: the seed-replicated z-test of
    ``tests/test_sharded.py:64-108`` (K = 8 seeds, 4 sigma), the toy.
(v) Windowed and chunked sweeps on 2 ranks equal the plain sweep there.
(vi) The argument checks; a one-rank local mesh is bit for bit the sweep
    without a mesh.

Every moment is checked equal on every rank, and the final carry is
gathered to full width (``gather_final``). Tolerances are relative to
each leaf's largest value. The plain versions' rounding on the CPU
depends on the batch width (the m = 40 draw/update on the same 8 columns
alone and within 32 differs by ~1e-12), and the toy's map amplifies it:
the toy's exact sweep at N = 32 on 4 ranks (8 particles each) differs
from one rank by 2.5e-10 of a leaf's largest value after 19 steps, at N =
64 (16 each) by 2e-16; so both models run 64 particles in (i).
"""

import numpy as np
import pytest
import torch

import _mesh_worker
import _sharded_apf_cases as cases
from bipk_tpu_torch.parallel.distributed import global_particle_mesh, init_distributed
from bipk_tpu_torch.parallel.mesh import ParticleMesh, chain_mesh, chain_sharding, particle_mesh
from bipk_tpu_torch.parallel.sharded import build_sharded_apf

N, N_ZTEST = 64, 128
K = 8  # z-test seeds
ZTEST_SEEDS = tuple(range(1000, 1000 + K))
SWEEP_SEED = 7
# (v): (chunk_size, window) of the windowed and chunked sweeps on 2 ranks
RUN_OPTIONS = {"plain": (None, None), "window": (None, 7), "chunk": (16, None),
               "chunk_window": (16, 7)}
# chunks are the local scheme's only (the JAX check, sharded.py:119-125)
SWEEP_OPTIONS = [("local", "window"), ("local", "chunk"), ("local", "chunk_window"),
                 ("exact", "window")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setups():
    return {"vehicle": cases.vehicle(12), "toy": cases.toy(10)}


def _one_rank(case):
    return _mesh_worker.run_inject(case, particle_mesh(device="cpu"))


@pytest.fixture(scope="module")
def ranks(setups, tmp_path_factory):
    """Every multi-rank case, run once per W: ``{W: (cases, rank results)}``."""
    veh = setups["vehicle"]
    out = {}
    for world in (2, 4):
        run = {f"exact_{name}": cases.inject_case(s, "exact", N, world)
               for name, s in setups.items()}
        if world == 2:
            run["ztest"] = dict(cases.toy(30).base, kind="sweeps", n=N_ZTEST,
                                scheme="local", seeds=ZTEST_SEEDS)
            for scheme, label in [("local", "plain"), ("exact", "plain"), *SWEEP_OPTIONS]:
                chunk, window = RUN_OPTIONS[label]
                run[f"{scheme}_{label}"] = dict(
                    veh.base, kind="sweeps", n=N, scheme=scheme, seeds=(SWEEP_SEED,),
                    chunk_size=chunk, window=window)
        out[world] = run, _mesh_worker.run_ranks(world, run, tmp_path_factory.mktemp(f"w{world}"))
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["vehicle", "toy"])
def test_exact_on_w_ranks_equals_one_rank(ranks, name, world):
    run, results = ranks[world]
    got = cases.case_results(results, f"exact_{name}")
    want = _one_rank(run[f"exact_{name}"])
    cases.assert_leaves_close(got, want, rtol=1e-12)


@pytest.mark.parametrize("name", ["vehicle", "toy"])
def test_exact_equals_local_on_one_rank(setups, name):
    case = cases.inject_case(setups[name], "exact", N)
    exact = _one_rank(case)
    local = _one_rank(dict(case, scheme="local"))
    assert all(np.all(np.isfinite(v)) for v in exact.values())
    cases.assert_leaves_close(exact, local, rtol=1e-12)


def _ztest_stats(res):
    """Time-averaged posterior interface-variable mean (after 10 steps)
    and the trace of the last step's weighted T1."""
    return (float(np.mean(res["int_var_mean0"][10:, 0])),
            float(np.trace(res["stats_mean0.T1"][-1])))


def test_local_on_two_ranks_matches_one_rank_statistically(ranks):
    """As ``tests/test_sharded.py:64-108``: for K seeds each run gives two
    scalar statistics; the difference of the two schemes' means must be
    within 4 of its measured standard errors (probability < 1e-4 under
    the hypothesis that both target the same posterior)."""
    run, results = ranks[2]
    case = run["ztest"]
    two = cases.case_results(results, "ztest")
    model = cases.toy(30).tmodel
    one_apf = build_sharded_apf(model.ssm, model.gps, N_ZTEST, forgetting_factor=1.0,
                                dtype=torch.float64, device="cpu")
    stats_2, stats_1 = [], []
    for seed in ZTEST_SEEDS:
        stats_2.append(_ztest_stats({k.split("/", 1)[1]: v for k, v in two.items()
                                     if k.startswith(f"{seed}/")}))
        res = one_apf(torch.Generator().manual_seed(seed), case["Y"], case["U"], model.x0,
                      model.p0)
        stats_1.append(_ztest_stats(_mesh_worker.result_leaves(res)))
    a, b = np.asarray(stats_2), np.asarray(stats_1)
    se = np.sqrt((a.var(0, ddof=1) + b.var(0, ddof=1)) / K)
    z = np.abs(a.mean(0) - b.mean(0)) / np.maximum(se, 1e-12)
    assert np.all(z < 4.0), (z, a.mean(0), b.mean(0), se)
    # the local scheme's mass offsets keep the global ESS healthy but below N
    ess = two[f"{ZTEST_SEEDS[0]}/ess"]
    assert np.all(ess >= 1.0) and np.all(ess <= N_ZTEST + 1e-9) and ess[1:].mean() > 0.1 * N_ZTEST


@pytest.mark.parametrize("scheme, label", SWEEP_OPTIONS)
def test_windowed_and_chunked_equal_the_plain_sweep_on_two_ranks(ranks, scheme, label):
    _, results = ranks[2]
    want = cases.case_results(results, f"{scheme}_plain")
    got = cases.case_results(results, f"{scheme}_{label}")
    if RUN_OPTIONS[label][0] is None:  # windows: the same operations, bit for bit
        cases.assert_leaves_close(got, want, rtol=0.0)
    else:
        cases.assert_leaves_close(got, want, rtol=1e-12)


def test_ranks_draw_their_own_particles(ranks):
    """On two ranks each rank draws from its own generator: the two halves
    of the final population differ (copies of one stream would not)."""
    _, results = ranks[2]
    res = cases.case_results(results, "local_plain")
    fs = res[f"{SWEEP_SEED}/final_state"]
    assert fs.shape[0] == N and not np.allclose(fs[: N // 2], fs[N // 2:])


def test_argument_checks():
    model = cases.vehicle(3).tmodel

    def build(**kw):
        return build_sharded_apf(model.ssm, model.gps, 64, device="cpu", **kw)

    three = ParticleMesh(None, 0, 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        build(mesh=three)
    with pytest.raises(ValueError, match="local resampling scheme only"):
        build(mesh=ParticleMesh(None, 0, 2, torch.device("cpu")), chunk_size=16,
              resampling_scheme="exact")
    with pytest.raises(ValueError, match="per-shard particle count 32 not divisible by "
                                         "chunk_size 24"):
        build(mesh=ParticleMesh(None, 0, 2, torch.device("cpu")), chunk_size=24)
    with pytest.raises(ValueError, match="not the mesh's"):
        build_sharded_apf(model.ssm, model.gps, 64, ParticleMesh(None, 0, 1, torch.device("meta")),
                          device="cpu")
    # a chunk of n_loc or more runs unchunked, per rank
    two = ParticleMesh(None, 0, 2, torch.device("cpu"))
    assert build(mesh=two, chunk_size=32).chunk_size is None
    assert build(mesh=two, chunk_size=16).n_loc == 32
    with pytest.raises(ValueError, match="needs a process group"):
        particle_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="init_distributed"):
        global_particle_mesh()
    with pytest.raises(ValueError, match="gloo ranks on the CPU"):
        init_distributed(device="cpu", local_device_count=8)
    with pytest.raises(ValueError, match="nothing else"):
        init_distributed(backend="nccl", device="cpu")
    for fn in (chain_mesh, chain_sharding):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 2"):
            fn(2)


@pytest.mark.parametrize("options", [{}, {"chunk_size": 16}, {"window": 5}],
                         ids=["plain", "chunked", "windowed"])
@pytest.mark.parametrize("name", ["vehicle", "toy"])
def test_one_rank_local_mesh_is_the_sweep_bit_for_bit(setups, name, options):
    s = setups[name]
    model = s.tmodel

    def sweep(**kw):
        apf = build_sharded_apf(model.ssm, model.gps, N, forgetting_factor=s.lam,
                                dtype=torch.float64, device="cpu", **options, **kw)
        return _mesh_worker.result_leaves(apf(torch.Generator().manual_seed(3), s.Y, s.U,
                                              model.x0, model.p0))

    mesh = particle_mesh(device="cpu")
    assert mesh.size == 1 and mesh.group is None
    cases.assert_leaves_close(sweep(mesh=mesh), sweep(), rtol=0.0)
