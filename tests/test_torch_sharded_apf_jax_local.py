"""The particle-sharded online APF, local scheme, on 2 gloo ranks against the
JAX package's ``build_sharded_apf`` on ``particle_mesh(2)`` with the JAX
sweep's draws injected (its key discipline, ``sharded.py:242-256,
429-447``): the vehicle (m = 20) and the toy (m = 40) at N = 32 over 11 and
9 steps in float64, every moment and the gathered final carry within 1e-10
of each leaf's largest value. Item (iii) of
``tests/test_torch_sharded_apf.py``; one file per scheme keeps each file's
JAX compiles (about 30 s for the toy's sweep alone) within the per-file
time budget."""

import pytest

import _sharded_apf_cases as cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return cases.jax_runs("local", tmp_path_factory.mktemp("w2"))


@pytest.mark.parametrize("name", ["vehicle", "toy"])
def test_two_ranks_match_jax_sharded_apf(runs, name):
    got, want = runs[name]
    cases.assert_leaves_close(got, want, rtol=1e-10)
