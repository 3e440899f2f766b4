"""The particle-sharded cSMC on 2 gloo ranks against the JAX package's
``build_sharded_csmc`` on ``particle_mesh(2)`` with the JAX sweep's draws
injected (its key discipline, ``sharded_csmc.py:161-167, 228-231, 508,
535-537``): the toy (m = 40) at N = 32 over 9 steps in float64,
conditioned on its simulated trajectory. The trajectory, the ESS and the
final weights within 1e-10 of each leaf's largest value, the emitted
ancestors (read off the JAX sweep's ``lax.scan``, per shard) exactly.
Item (vii) of ``tests/test_torch_sharded_csmc.py``; one file per model
keeps each file's JAX compile within the per-file time budget."""

import numpy as np
import pytest

import _sharded_apf_cases as apf_cases
import _sharded_csmc_cases as cases


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        return cases.jax_run(cases.toy(10), tmp_path_factory.mktemp("w2"), mp)


def test_two_ranks_match_jax_sharded_csmc(run):
    got, want = run
    np.testing.assert_array_equal(got["ancestors"], want["ancestors"])
    apf_cases.assert_leaves_close(got, want, rtol=1e-10)
