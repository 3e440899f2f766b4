"""The port's toy, oscillator and vehicle entry scripts
(``bipk_tpu_torch/scripts/``) and the modules they brought: the
predictive functions of ``ops/mniw.py``, ``utils/profiling.py``,
``utils/plotting.py`` and the batch-first ``init_particles`` /
``weighted_stats`` of ``algorithms/apf.py``, on the CPU.

Each script's ``run()`` at a tiny size writes exactly its ``MAT_KEYS``,
finite. Each ``MAT_KEYS`` equals the key set of the JAX script's ``.mat``
dictionary, read from the script's source: its ``mdict`` literal, whose
``**matio.*_entries(...)`` parts are evaluated with the JAX package's own
``matio`` on stand-in results (the JAX scripts themselves take 86-205 s
each at 8 particles and 3 sweeps on an 8-core CPU, most of it compiling,
past this file's time). The predictive functions match JAX to rtol 1e-10 in
float64; the plotting reductions and ``weighted_stats`` match JAX's.
"""

import ast
import sys
from collections import namedtuple
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from bipk_tpu.algorithms import apf as japf
from bipk_tpu.ops import mniw as jmniw
from bipk_tpu.utils import matio as jmatio
from bipk_tpu.utils import plotting as jplotting
from bipk_tpu_torch.algorithms import apf as tapf
from bipk_tpu_torch.models import vehicle as tveh
from bipk_tpu_torch.ops import mniw
from bipk_tpu_torch.scripts import single_mass_oscillator, toy_example, vehicle
from bipk_tpu_torch.utils import checkpoint, matio, plotting, profiling

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = {"toy_example": toy_example, "single_mass_oscillator": single_mass_oscillator,
           "vehicle": vehicle}
# a tiny run of each: 8 particles, 3 Gibbs iterations, 15 steps where the
# script takes --t-end (the toy has its 40)
TINY = {"toy_example": ["--no-plot"], "single_mass_oscillator": ["--t-end", "0.3"],
        "vehicle": ["--t-end", "0.3"]}
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes; one intra-op thread per
    worker keeps the torch side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _out(tmp_path, name):
    return str(tmp_path / name) + ("" if name == "toy_example" else ".mat")


def _mat(path):
    path = path if path.endswith(".mat") else path + ".mat"
    return {k: v for k, v in scipy.io.loadmat(path).items() if not k.startswith("__")}


def _run(name, tmp_path, *extra, hook=None, out=None):
    script = SCRIPTS[name]
    out = out or _out(tmp_path, name)
    args = script.parse_args(["--cpu", "--particles", "8", "--gibbs-iters", "3", *TINY[name],
                              "--out", out, *extra])
    return script.run(args, hook=hook), out


@pytest.mark.parametrize("name", SCRIPTS)
def test_run_writes_the_mat_keys(name, tmp_path):
    events = []
    mdict, out = _run(name, tmp_path, hook=lambda event, **info: events.append(event))
    mat = _mat(out)
    assert set(mat) == set(mdict) == SCRIPTS[name].MAT_KEYS
    for k, v in mat.items():
        assert np.isfinite(v).all(), k
    assert events[:3] == ["model", "online", "reference"]
    assert events[3:6] == ["gibbs-sweep", "gibbs-sweep", "gibbs"]
    T = 40 if name == "toy_example" else 15
    assert mat["offline_Sigma_X"].shape[:2] == (T, 3)
    assert mat["online_Sigma_X"].shape[:2] == (T, 8)
    if name == "toy_example":  # classic PGAS: 3x the Gibbs iterations
        assert events[6:] == ["pgas-sweep"] * 8 + ["pgas", "predictive"]
        assert mat["baseline_Sigma_X"].shape == (T, 9, 1)


def _jax_script_keys(name):
    """The keys of the ``mdict`` literal of ``scripts/<name>.py`` (the JAX
    script), its ``**matio.*(...)`` parts evaluated with the JAX
    package's ``matio`` on stand-in results."""
    path = REPO / "scripts" / f"{name}.py"
    tree = ast.parse(path.read_text())
    dicts = [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
             and any(getattr(t, "id", None) == "mdict" for t in n.targets)]
    assert len(dicts) == 1 and isinstance(dicts[0], ast.Dict)
    # nothing else adds to it: no mdict[...] = ..., no mdict.update(...)
    for n in ast.walk(tree):
        targets = getattr(n, "targets", [])
        assert not any(isinstance(t, ast.Subscript) and getattr(t.value, "id", None) == "mdict"
                       for t in targets)
        assert not (isinstance(n, ast.Attribute) and getattr(n.value, "id", None) == "mdict")
    Stats = namedtuple("Stats", "T0 T1 T2 T3")
    stats = Stats(0, 0, 0, 0)
    result = SimpleNamespace(states=0, outputs=0, weights=0, log_likelihood=0,
                             stats=[stats, stats], stats_mean=[stats, stats])
    model = SimpleNamespace(gp=SimpleNamespace(prior=stats),
                            gps=[SimpleNamespace(prior=stats)] * 2)
    env = {"matio": jmatio, "offline": result, "online": result, "model": model}
    keys = set()
    for k, v in zip(dicts[0].keys, dicts[0].values):
        if k is None:
            keys |= set(eval(compile(ast.Expression(v), str(path), "eval"), env))
        else:
            keys.add(k.value)
    return keys


@pytest.mark.parametrize("name", SCRIPTS)
def test_mat_keys_equal_the_jax_scripts(name):
    assert SCRIPTS[name].MAT_KEYS == _jax_script_keys(name)


def test_toy_mat_file_is_the_same_with_and_without_the_figure(tmp_path):
    _, plain = _run("toy_example", tmp_path, out=str(tmp_path / "plain"))
    args = toy_example.parse_args(["--cpu", "--particles", "8", "--gibbs-iters", "3",
                                   "--out", str(tmp_path / "drawn")])
    toy_example.run(args)
    assert (tmp_path / "drawn.pdf").stat().st_size > 0
    assert not (tmp_path / "plain.pdf").exists()
    a, b = _mat(plain), _mat(str(tmp_path / "drawn"))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_toy_without_matplotlib_names_the_flag(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    args = toy_example.parse_args(["--cpu", "--out", str(tmp_path / "t")])
    with pytest.raises(ImportError, match="--no-plot"):
        toy_example.run(args)
    assert not (tmp_path / "t.mat").exists()


def test_toy_chains_print_their_diagnostics(tmp_path, capsys):
    seen = {}
    mdict, _ = _run("toy_example", tmp_path, "--chains", "2",
                    hook=lambda event, **info: seen.setdefault(event, info))
    assert seen["gibbs"]["result"].states.shape == (2, 40, 3, 1)
    assert mdict["offline_Sigma_X"].shape == (40, 3, 1)  # chain 0
    said = capsys.readouterr().out
    assert "3 Gibbs sweeps x 2 chains" in said
    assert "post-burn-in diagnostics over 2 chains: R-hat" in said or "never moved" in said


def test_vehicle_profile_writes_a_trace_and_keeps_the_results(tmp_path):
    plain, _ = _run("vehicle", tmp_path, out=str(tmp_path / "plain.mat"))
    traced, _ = _run("vehicle", tmp_path, "--profile", str(tmp_path / "trace"),
                     out=str(tmp_path / "traced.mat"))
    assert (tmp_path / "trace" / profiling.TRACE_FILE).stat().st_size > 0
    for k in plain:  # the warm-up's draws are replayed
        np.testing.assert_array_equal(matio.to_host(traced[k]), matio.to_host(plain[k]),
                                      err_msg=k)


def test_oscillator_checkpoint_resumes_two_chains(tmp_path):
    """``--chains 2 --checkpoint``: interrupted after sweep 3, then run
    again, the script writes what the uninterrupted run writes."""
    extra = ["--gibbs-iters", "6", "--chains", "2"]
    full, _ = _run("single_mass_oscillator", tmp_path, *extra, out=str(tmp_path / "a.mat"))
    ckpt = ["--checkpoint", str(tmp_path / "smo.ckpt"), "--checkpoint-every", "2"]

    class Interrupted(RuntimeError):
        pass

    def interrupt(event, **info):
        if event == "gibbs-sweep" and info["k"] == 3:
            raise Interrupted()

    with pytest.raises(Interrupted):
        _run("single_mass_oscillator", tmp_path, *extra, *ckpt, hook=interrupt,
             out=str(tmp_path / "b.mat"))
    assert checkpoint.load(str(tmp_path / "smo.ckpt"))[0] == 2
    resumed, _ = _run("single_mass_oscillator", tmp_path, *extra, *ckpt,
                      out=str(tmp_path / "b.mat"))
    for k in full:
        np.testing.assert_array_equal(matio.to_host(resumed[k]), matio.to_host(full[k]),
                                      err_msg=k)


@pytest.mark.parametrize("name", ["single_mass_oscillator", "vehicle"])
def test_mesh_without_a_process_group_runs_one_rank(name, tmp_path):
    """``--mesh 1`` without a process group is a one-rank mesh: with
    ``--chains 2`` the chain mesh writes what ``--chains 2`` alone writes,
    bit for bit; without chains the particle-sharded cSMC writes the
    script's keys, all finite. More ranks raise, naming torchrun
    (``tests/test_torch_mesh_scripts.py`` runs them on gloo ranks)."""
    with pytest.raises(ValueError, match="torchrun"):
        SCRIPTS[name].parse_args(["--cpu", "--mesh", "2"])
    want, _ = _run(name, tmp_path, "--chains", "2", out=str(tmp_path / "a.mat"))
    got, _ = _run(name, tmp_path, "--chains", "2", "--mesh", "1", out=str(tmp_path / "b.mat"))
    for k in want:
        np.testing.assert_array_equal(matio.to_host(got[k]), matio.to_host(want[k]), err_msg=k)
    _, out = _run(name, tmp_path, "--mesh", "1", out=str(tmp_path / "c.mat"))
    mat = _mat(out)
    assert set(mat) == SCRIPTS[name].MAT_KEYS and all(np.isfinite(v).all() for v in mat.values())


def _nat(rng, m, n):
    A = rng.standard_normal((m, m))
    B = rng.standard_normal((n, n))
    return (rng.standard_normal((m, n)), A @ A.T + m * np.eye(m) + 0.1 * A,
            B @ B.T + 5.0 * n * np.eye(n), np.asarray(12.0))


def _close(got, want, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("m,n", [(6, 1), (9, 2)])
def test_predictive_functions_match_jax(m, n):
    rng = np.random.default_rng(m + n)
    nat = _nat(rng, m, n)  # T1 not symmetric: factorize symmetrizes it
    phi = rng.standard_normal((m, 5))
    jf = jmniw.factorize(jmniw.MNIW(*(jnp.asarray(a) for a in nat)))
    tf = mniw.factorize(mniw.MNIW(*(torch.as_tensor(a) for a in nat)))
    for got, want in zip(tf, jf):
        _close(got, want)
    jpred = jax.vmap(lambda p: jmniw.factor_predictive(jf, p))(jnp.asarray(phi.T))
    tpred = mniw.factor_predictive(tf, torch.as_tensor(phi))
    _close(tpred.mean, np.asarray(jpred.mean).T)
    _close(tpred.col_scale, jpred.col_scale)
    _close(tpred.row_scale, jpred.row_scale[0])
    _close(tpred.df, jpred.df[0])
    one = mniw.factor_predictive(tf, torch.as_tensor(phi[:, 0]))
    for got, want in zip(one, jmniw.factor_predictive(jf, jnp.asarray(phi[:, 0]))):
        _close(got, want)
    mean = rng.standard_normal((n, m))
    C = rng.standard_normal((m, m))
    col_cov, row_scale = C @ C.T + np.eye(m), np.eye(n) * 0.3
    want = jmniw.predictive(*(jnp.asarray(a) for a in (mean, col_cov, row_scale)), 7.0,
                            jnp.asarray(phi[:, 1]))
    got = mniw.predictive(*(torch.as_tensor(a) for a in (mean, col_cov, row_scale)),
                          torch.tensor(7.0, dtype=F64), torch.as_tensor(phi[:, 1]))
    for g, w in zip(got, want):
        _close(g, w)
    many = mniw.predictive(*(torch.as_tensor(a) for a in (mean, col_cov, row_scale)),
                           torch.tensor(7.0, dtype=F64), torch.as_tensor(phi))
    _close(many.mean[:, 1], want.mean)
    _close(many.col_scale[1], want.col_scale)


def test_profile_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with profiling.profile_trace(str(tmp_path / "t")) as prof:
        y, seconds = profiling.timed(lambda: x @ x)
    assert prof is not None and seconds >= 0.0
    trace = tmp_path / "t" / profiling.TRACE_FILE
    assert trace.stat().st_size > 0 and "traceEvents" in trace.read_text()[:2000]
    with profiling.profile_trace(None) as prof:
        assert prof is None
    assert profiling.block((y, [x], {"a": x}))[0] is y
    with profiling.Timer("t") as timer:
        pass
    assert timer.count == 1 and timer.throughput(10.0) > 0.0


def test_plotting_reductions_match_jax():
    rng = np.random.default_rng(3)
    w = rng.uniform(size=(5, 7))
    w /= w.sum(1, keepdims=True)
    x = rng.standard_normal((5, 7, 2))
    for got, want in zip(plotting.weighted_moments(x, w), jplotting.weighted_moments(x, w)):
        _close(got, want)
    _close(plotting.weighted_moments(x[..., 0], w)[0], jplotting.weighted_moments(x[..., 0], w)[0])
    vals, truth = rng.standard_normal((11, 3)), rng.standard_normal(11)
    ws = rng.uniform(size=(11, 3))
    _close(plotting.calc_wrmse(ws, vals, truth), jplotting.calc_wrmse(ws, vals, truth))
    var = rng.uniform(0.5, 2.0, size=(4, 11))
    _close(plotting.calc_wrmse_precision(vals.T[:1].repeat(4, 0), var, truth),
           jplotting.calc_wrmse_precision(vals.T[:1].repeat(4, 0), var, truth))


def test_batch_first_helpers():
    """``init_particles``: batch-first layouts of ``APFKernel.init_particles``'
    draws, each particle's statistics the rank-1 statistics of its
    interface variable at its basis; ``weighted_stats`` against JAX's."""
    model = tveh.make_model(tveh.VehicleConfig(t_end=0.1))
    u0 = torch.tensor([0.05, 11.0], dtype=F64)
    lw, state, ivs, stats = tapf.init_particles(
        torch.Generator().manual_seed(0), model.ssm, model.gps, 32, u0, model.x0,
        model.p0, dtype=F64, device="cpu")
    assert lw.shape == (32,) and state.shape == (32, 2) and ivs[1].shape == (32, 1)
    assert stats[0].T1.shape == (32, 20, 20) and stats[0].T0.shape == (32, 20, 1)
    phi = model.gps[1].basis_fn_bl(state.T, u0[:, None])  # (20, 32)
    _close(stats[1].T1, torch.einsum("in,jn->nij", phi, phi))
    _close(stats[1].T0[:, :, 0], phi.T * ivs[1])
    _close(stats[1].T3, torch.ones(32, dtype=F64))
    w = torch.softmax(torch.randn(32, dtype=F64, generator=torch.Generator().manual_seed(1)), 0)
    want = japf.weighted_stats(
        tuple(jmniw.MNIW(*(jnp.asarray(leaf.numpy()) for leaf in st)) for st in stats),
        jnp.asarray(w.numpy()))
    for got_st, want_st in zip(tapf.weighted_stats(stats, w), want):
        for g, w_ in zip(got_st, want_st):
            _close(g, w_)
