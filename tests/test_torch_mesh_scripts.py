"""``--mesh N`` through the vehicle and EMPS scripts' ``run()`` on 2 gloo
ranks (``tests/_mesh_worker.py``: each rank a child process, 120 s for the
group), ``--cpu`` at tiny sizes.

(i) With ``--chains 2`` (the chain mesh, one chain per rank) every rank
    returns the ``.mat`` dictionary of the same run with ``--chains 2``
    and no mesh, bit for bit.
(ii) Without chains (the particle-sharded cSMC) every rank returns the
    script's keys, all finite, and the same values.
(iii) Only rank 0 writes the ``.mat`` file.
"""

import numpy as np
import pytest
import scipy.io
import torch

import _mesh_worker
import _sharded_apf_cases as apf_cases
from bipk_tpu_torch.scripts import emps as emps_script
from bipk_tpu_torch.scripts import vehicle as veh_script
from bipk_tpu_torch.utils import matio

SCRIPTS = {"vehicle": veh_script, "emps": emps_script}
ARGV = {
    "vehicle": ["--cpu", "--particles", "16", "--gibbs-iters", "3", "--t-end", "0.5"],
    "emps": ["--cpu", "--particles", "16", "--gibbs-iters", "3", "--max-steps", "40",
             "--skip-baseline"],
}
BASELINE = {"offline_Sigma_X_PGAS", "offline_log_likelihood_PGAS", "RMSE_Alg2", "RMSE_PGAS"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scripts")
    run = {}
    for name, argv in ARGV.items():
        for mode, extra in (("chains", ["--chains", "2"]), ("shard", [])):
            run[f"{name}_{mode}"] = dict(kind="script", script=name,
                                         argv=[*argv, "--mesh", "2", *extra],
                                         out=str(tmp / f"{name}_{mode}"))
    return run, _mesh_worker.run_ranks(2, run, tmp)


def _keys(name):
    return SCRIPTS[name].MAT_KEYS - (BASELINE if name == "emps" else set())


@pytest.mark.parametrize("name", ["vehicle", "emps"])
def test_mesh_with_chains_equals_the_chains_without_a_mesh(ranks, tmp_path, name):
    _, results = ranks
    got = apf_cases.case_results(results, f"{name}_chains")  # equal on both ranks
    script = SCRIPTS[name]
    want = script.run(script.parse_args([*ARGV[name], "--chains", "2",
                                         "--out", str(tmp_path / "one.mat")]))
    assert set(got) == set(want) == _keys(name)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(matio.to_host(v)), err_msg=k)


@pytest.mark.parametrize("name", ["vehicle", "emps"])
def test_mesh_without_chains_runs_the_sharded_csmc(ranks, name):
    _, results = ranks
    got = apf_cases.case_results(results, f"{name}_shard")  # equal on both ranks
    assert set(got) == _keys(name)
    assert all(np.all(np.isfinite(v)) for v in got.values())
    assert got["offline_Sigma_X"].shape[1] == 3  # the reference and two sweeps


@pytest.mark.parametrize("case", ["vehicle_chains", "vehicle_shard", "emps_chains",
                                  "emps_shard"])
def test_only_rank_zero_writes_the_mat(ranks, case):
    run, results = ranks
    out = run[case]["out"]
    mat = scipy.io.loadmat(f"{out}.rank0.mat")
    assert {k for k in mat if not k.startswith("__")} == _keys(case.split("_")[0])
    with pytest.raises(FileNotFoundError):
        open(f"{out}.rank1.mat")
