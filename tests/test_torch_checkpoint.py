"""The port's checkpoints (``bipk_tpu_torch.utils.checkpoint``) and the
checkpointed Gibbs host loop, the cases of ``tests/test_checkpoint.py``
on the CPU in float64: a round trip, a missing file, the periodic
checkpointer, a loop that writes its chain state, and a resume that
continues the chain bit for bit, for one chain and for two; then the JAX
``run_host``'s three refusals. The toy sampler runs at a few particles."""

import numpy as np
import pytest
import torch

from bipk_tpu_torch.algorithms.apf import build_apf
from bipk_tpu_torch.algorithms.gibbs import build_gibbs
from bipk_tpu_torch.models import toy
from bipk_tpu_torch.ops import mniw
from bipk_tpu_torch.utils import checkpoint
from bipk_tpu_torch.utils.matio import sample_reference_trajectory

F64 = torch.float64
N_PARTICLES, N_STEPS, N_ITER = 16, 15, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes; one intra-op thread per
    worker keeps the torch side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_roundtrip(tmp_path):
    path = str(tmp_path / "ckpt.pkl")
    g = torch.Generator().manual_seed(42)
    torch.rand(3, generator=g)
    payload = {"traj": torch.arange(12.0, dtype=F64).reshape(3, 4),
               "stats": (mniw.MNIW(torch.ones((2, 1)), torch.eye(2), torch.ones((1, 1)),
                                   torch.tensor(3.0)),)}
    checkpoint.save(path, 17, g.get_state(), payload)
    step, state, loaded = checkpoint.load(path)
    assert step == 17
    assert torch.equal(state, g.get_state()) and state.dtype == torch.uint8
    np.testing.assert_array_equal(loaded["traj"], np.arange(12.0).reshape(3, 4))
    assert loaded["traj"].dtype == np.float64
    assert isinstance(loaded["stats"][0], mniw.MNIW)
    np.testing.assert_array_equal(loaded["stats"][0].T1, np.eye(2))
    # the restored state produces the same stream
    g2 = torch.Generator().manual_seed(0)
    g2.set_state(state)
    assert torch.equal(torch.rand(5, generator=g), torch.rand(5, generator=g2))
    assert not (tmp_path / "ckpt.pkl.tmp").exists()


def test_load_missing_returns_none(tmp_path):
    assert checkpoint.load(str(tmp_path / "nope.pkl")) is None


def test_periodic_checkpointer(tmp_path):
    path = str(tmp_path / "p.pkl")
    cb = checkpoint.PeriodicCheckpointer(path, every=3)
    g = torch.Generator().manual_seed(0)
    states = {}
    for k in range(1, 8):
        torch.rand(2, generator=g)  # an evolving chain generator
        states[k] = g.get_state()
        cb(k, g.get_state(), {"k": torch.tensor(k)})
    step, saved, payload = checkpoint.load(path)
    assert step == 6  # last multiple of 3
    assert int(payload["k"]) == 6
    # the saved state is the CURRENT one at step 6, not the first
    assert torch.equal(saved, states[6]) and not torch.equal(saved, states[1])


def test_periodic_checkpointer_builds_only_what_it_saves(tmp_path):
    """Given functions, the checkpointer calls them on the iterations it
    saves and on no other; a non-positive period is refused."""
    path = str(tmp_path / "lazy.pkl")
    cb = checkpoint.PeriodicCheckpointer(path, every=2)
    g = torch.Generator().manual_seed(0)
    built = []

    def payload(k):
        built.append(k)
        return {"k": torch.tensor(k)}

    for k in range(1, 6):
        cb(k, g.get_state, lambda k=k: payload(k))
    assert built == [2, 4]
    step, saved, loaded = checkpoint.load(path)
    assert step == 4 and int(loaded["k"]) == 4 and torch.equal(saved, g.get_state())
    with pytest.raises(ValueError, match="checkpoint_every must be positive, got 0"):
        checkpoint.PeriodicCheckpointer(path, every=0)


@pytest.fixture(scope="module")
def toy_setup():
    cfg = toy.ToyConfig(n_particles=N_PARTICLES, n_steps=N_STEPS)
    model = toy.make_model(cfg)
    X, Y = toy.simulate(torch.Generator().manual_seed(0), cfg, dtype=F64, device="cpu")
    inputs = torch.zeros((N_STEPS, 0), dtype=F64)
    g = torch.Generator().manual_seed(1)
    apf = build_apf(model.ssm, model.gps, N_PARTICLES, 1.0, dtype=F64, device="cpu")
    res = apf(g, Y, inputs, model.x0, model.p0)
    ref_state, ref_iv = sample_reference_trajectory(torch.rand((1,), generator=g, dtype=F64), res)
    return model, Y, inputs, ref_state, ref_iv


def _run(toy_setup, n_chains=None, seed=2, n_iter=N_ITER, **kwargs):
    model, Y, inputs, ref_state, ref_iv = toy_setup
    gibbs = build_gibbs(model.ssm, model.gps, N_PARTICLES, n_iter, dtype=F64, device="cpu",
                        n_chains=n_chains)
    g = torch.Generator().manual_seed(seed)
    return gibbs(g, Y, inputs, model.x0, model.p0, ref_state, ref_iv, **kwargs)


def _assert_same(got, want):
    for name in ("states", "outputs", "log_likelihood", "weights"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(got.int_vars[0], want.int_vars[0])
    for a, b in zip(got.stats[0], want.stats[0]):
        assert torch.equal(a, b)


def test_gibbs_host_loop_writes_checkpoints(toy_setup, tmp_path):
    """The host-loop Gibbs sampler checkpoints its whole chain state."""
    path = str(tmp_path / "gibbs.pkl")
    out = _run(toy_setup, checkpoint_path=path, checkpoint_every=2)
    assert out.states.shape == (N_STEPS, N_ITER, 1)
    step, state, payload = checkpoint.load(path)
    assert step == 6  # last multiple of 2 before the final iteration (7)
    refs = payload["refs"]
    assert len(refs) == 7  # the initial draw and 6 sweeps
    assert refs[-1][0].shape == (N_STEPS, 1)
    np.testing.assert_array_equal(refs[-1][0], out.states[:, 6].numpy())
    assert state.dtype == torch.uint8


class Boom(RuntimeError):
    pass


@pytest.mark.parametrize("n_chains", [None, 2], ids=["one-chain", "two-chains"])
def test_gibbs_resume_continues_chain_exactly(toy_setup, tmp_path, n_chains):
    """Kill mid-run, resume, and the chain CONTINUES (not replays): the
    resumed run is bit for bit the uninterrupted one, which needs the
    generators' states after the last saved sweep (with chains, each
    chain's own generator)."""
    full = _run(toy_setup, n_chains)
    path = str(tmp_path / "crash.pkl")
    seen = []

    def crash_at_5(k, ref):
        seen.append(k)
        if k == 5:
            raise Boom()

    with pytest.raises(Boom):
        _run(toy_setup, n_chains, callback=crash_at_5, checkpoint_path=path, checkpoint_every=2)
    assert seen == [1, 2, 3, 4, 5]
    step, state, _ = checkpoint.load(path)
    assert step == 4  # last checkpoint before the crash
    assert isinstance(state, list) == (n_chains is not None)

    resumed_at = []
    resumed = _run(toy_setup, n_chains, callback=lambda k, ref: resumed_at.append(k),
                   checkpoint_path=path, checkpoint_every=2)
    assert resumed_at == [5, 6, 7]
    _assert_same(resumed, full)
    if n_chains:
        assert resumed.states.shape == (2, N_STEPS, N_ITER, 1)


def test_chains_resume_from_their_own_generators(toy_setup, tmp_path):
    """The chains' generators are seeded from the caller's once, before the
    first sweep, so the caller's state alone cannot resume them: the
    checkpoint holds each chain's state, and a resume continues the chains
    from those whatever the caller's generator holds."""
    full = _run(toy_setup, 2, n_iter=5)
    path = str(tmp_path / "c.pkl")

    def crash_at_3(k, ref):
        if k == 3:
            raise Boom()

    with pytest.raises(Boom):
        _run(toy_setup, 2, n_iter=5, callback=crash_at_3, checkpoint_path=path,
             checkpoint_every=2)
    _, states, _ = checkpoint.load(path)
    assert len(states) == 2 and not torch.equal(states[0], states[1])
    _assert_same(_run(toy_setup, 2, seed=99, n_iter=5, checkpoint_path=path), full)


def test_refusals(toy_setup, tmp_path):
    path = str(tmp_path / "r.pkl")
    with pytest.raises(ValueError, match="checkpoint_every must be positive, got 0"):
        _run(toy_setup, checkpoint_path=path, checkpoint_every=0)
    _run(toy_setup, n_iter=4, checkpoint_path=path, checkpoint_every=1)
    assert checkpoint.load(path)[0] == 3
    with pytest.raises(ValueError, match="is at iteration 3 but this sampler runs only 3 "
                                         "iterations; it belongs to a different run"):
        _run(toy_setup, n_iter=3, checkpoint_path=path)
    with pytest.raises(ValueError, match=r"holds trajectories of shape \(15, 1\).*2 chains"):
        _run(toy_setup, 2, checkpoint_path=path)
    model, Y, inputs, ref_state, ref_iv = toy_setup
    gibbs = build_gibbs(model.ssm, model.gps, N_PARTICLES, N_ITER, dtype=F64, device="cpu")
    with pytest.raises(ValueError, match=r"\(15, 1\), which does not match this run \(10 steps"):
        gibbs(torch.Generator().manual_seed(2), Y[:10], inputs[:10], model.x0, model.p0,
              ref_state[:10], tuple(v[:10] for v in ref_iv), checkpoint_path=path)
    chains = str(tmp_path / "chains.pkl")
    _run(toy_setup, 2, n_iter=3, checkpoint_path=chains, checkpoint_every=1)
    with pytest.raises(ValueError, match=r"shape \(2, 15, 1\).*3 chains"):
        _run(toy_setup, 3, checkpoint_path=chains)
    with pytest.raises(ValueError, match=r"shape \(2, 15, 1\)"):
        _run(toy_setup, checkpoint_path=chains)
