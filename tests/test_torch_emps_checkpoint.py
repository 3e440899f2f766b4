"""The EMPS entry point's ``--checkpoint`` (``bipk_tpu_torch.scripts.emps``
on the checkpointed Gibbs host loop), on the CPU: an interrupted run,
resumed, writes what the uninterrupted run writes, bit for bit. A file of
its own: three EMPS runs at ``--quick`` take most of a minute on the
CPU."""

import numpy as np
import pytest
import torch

from bipk_tpu_torch.scripts import emps as emps_script
from bipk_tpu_torch.utils import matio


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes; one intra-op thread per
    worker keeps the torch side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_point_resumes_its_gibbs_chain_bit_for_bit(tmp_path):
    """``--quick --cpu --skip-baseline --checkpoint``: a run interrupted
    after Gibbs sweep 5 (a hook that raises; checkpoints every 2 sweeps),
    then run again with the same flags, writes what the uninterrupted run
    writes, bit for bit."""
    def args(name, *extra):
        return emps_script.parse_args(["--quick", "--cpu", "--skip-baseline",
                                       "--data-dir", str(tmp_path),
                                       "--out", str(tmp_path / f"{name}.mat"), *extra])

    full = emps_script.run(args("full"))

    class Interrupted(RuntimeError):
        pass

    def interrupt(event, **info):
        if event == "gibbs-sweep" and info["k"] == 5:
            raise Interrupted()

    ckpt = ["--checkpoint", str(tmp_path / "emps.ckpt"), "--checkpoint-every", "2"]
    with pytest.raises(Interrupted):
        emps_script.run(args("cut", *ckpt), hook=interrupt)
    resumed = emps_script.run(args("resumed", *ckpt))
    assert resumed.keys() == full.keys()
    for key in full:
        np.testing.assert_array_equal(matio.to_host(resumed[key]), matio.to_host(full[key]),
                                      err_msg=key)
