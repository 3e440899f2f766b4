"""The check rejects a broken program: each cell's run, at a size the CPU
holds and with the card's check skipped, driven with the timed path broken
underneath, has to come out not correct; the control (the reference in
float32 with TF32 operands, put in the program's place) too. The CPU runs
the port's plain versions, not its kernels, so the limits here are the
cell's, each raised to ten times the sound run's reading at this size,
under which the sound run is correct."""

import json
import time

import pytest
import torch

from portbench import _tiny, harness

APF_CELLS = ["vehicle-apf-1m", "oscillator-apf-32k"]
GIBBS_CELL = "vehicle-gibbs-256k"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = _tiny.tiny_root(tmp_path_factory.mktemp("tiny"))
    for cell in APF_CELLS + [GIBBS_CELL]:
        path = root / "portbench" / "limits" / f"{cell}.json"
        limits = json.loads(path.read_text())
        sound = _tiny.run(root, cell)["checks"]
        path.write_text(json.dumps({k: max(v, 10 * sound[k]["value"]) for k, v in limits.items()}))
    return root


def _correct(root, cell):
    return _tiny.run(root, cell)["correct"]


@pytest.mark.parametrize("cell", APF_CELLS + [GIBBS_CELL])
def test_sound(root, cell):
    assert _correct(root, cell)


def _unchanged_apf(self, carry, obs, inp_prev, inp_cur, draws, out=None):
    return carry, self.moments(self.softmax(carry[0]), *carry[1:])


def _half_moments(orig):
    def moments(self, w, state, int_vars, Ss):
        h = w.shape[0] // 2
        wh = w[:h] / w[:h].sum()
        return orig(self, wh, state[:, :h], tuple(v[:, :h] for v in int_vars),
                    tuple(S[:, :h] for S in Ss))
    return moments


def _altered_apf(orig):
    def step(self, *args, **kw):
        carry, mom = orig(self, *args, **kw)
        iv = carry[2][0].clone()
        iv[:, 0] += 0.05
        return (carry[0], carry[1], (iv, *carry[2][1:]), carry[3]), mom
    return step


def _identity_ancestors(self, w, u):
    return torch.arange(w.shape[0], dtype=torch.int32, device=w.device), None


def _shifted_ancestors(orig):
    def local_ancestors(self, w, u):
        anc, offset = orig(self, w, u)
        return (anc + 1).clamp(max=w.shape[0] - 1).to(anc.dtype), offset
    return local_ancestors


@pytest.mark.parametrize("cell", APF_CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "identity_ancestors",
                                   "shifted_ancestors"])
def test_apf_faults(root, cell, fault, monkeypatch):
    from bipk_tpu_torch.parallel.sharded import ShardedAPF

    if fault == "unchanged":
        monkeypatch.setattr(ShardedAPF, "step", _unchanged_apf)
    elif fault == "half":
        monkeypatch.setattr(ShardedAPF, "moments", _half_moments(ShardedAPF.moments))
    elif fault == "altered":
        monkeypatch.setattr(ShardedAPF, "step", _altered_apf(ShardedAPF.step))
    elif fault == "identity_ancestors":
        monkeypatch.setattr(ShardedAPF, "local_ancestors", _identity_ancestors)
    else:
        monkeypatch.setattr(ShardedAPF, "local_ancestors",
                            _shifted_ancestors(ShardedAPF.local_ancestors))
    assert not _correct(root, cell)


def _unchanged_csmc(self, carry, *args, **kw):
    N = carry[1].shape[1]
    w = torch.softmax(carry[0], 0)
    anc = torch.arange(N, dtype=torch.int32, device=carry[1].device)
    return carry, (anc, 1.0 / (w * w).sum())


def _half_softmax(x):
    h = x.shape[0] // 2
    w = torch.zeros_like(x)
    w[:h] = torch.softmax(x[:h], 0)
    return w


def _altered_result(orig):
    def result(self, tr, u):
        res = orig(self, tr, u)
        traj = res.state_traj.clone()
        traj[traj.shape[0] // 2, 0] += 1e-3
        return res._replace(state_traj=traj)
    return result


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_gibbs_faults(root, fault, monkeypatch):
    from bipk_tpu_torch.algorithms.csmc import CSMC

    if fault == "unchanged":
        monkeypatch.setattr(CSMC, "step", _unchanged_csmc)
    elif fault == "half":
        monkeypatch.setattr(CSMC, "softmax", staticmethod(_half_softmax))
    else:
        monkeypatch.setattr(CSMC, "result", _altered_result(CSMC.result))
    assert not _correct(root, GIBBS_CELL)


@pytest.mark.parametrize("cell", APF_CELLS + [GIBBS_CELL])
def test_control(root, cell):
    man = harness.manifest(root)
    files = harness.cell_files(man, cell, root / "portbench")
    ctx, driver = harness.drive(files, 2_200_000_023, 1e9, False, time.perf_counter(),
                                torch.device("cpu"), until_checked=True)
    numbers = driver.readings(ctx, True)[1]
    limits = {k: v for k, v in files.limits.items() if k in numbers}
    assert limits and not harness.judge(numbers, limits)[0]
