"""The port's EMPS model (``bipk_tpu_torch.models.emps``), its ``.mat``
writers and its entry point against the JAX package, on the CPU in
float64.

The surrogate data, the preprocessing, both bases and both priors (through
``convert.emps_arrays``), the RK4 transition and the validation RMSE agree
to rtol 1e-10; so do a few online APF steps with the JAX sweep's draws
injected (the key splits of ``apf.py:631-652`` and the draw-update's
``key_u, key_v`` split, one GP), and the ``online_entries`` /
``offline_entries`` / ``prior_entries`` dictionaries. The entry point runs
a small experiment and writes a ``.mat`` file with ``scripts/emps.py``'s
keys.
"""

import dataclasses
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from bipk_tpu.algorithms.apf import APFKernel as JAPFKernel
from bipk_tpu.algorithms.apf import build_apf as jbuild_apf
from bipk_tpu.models import emps as jemps
from bipk_tpu.utils import matio as jmatio
from bipk_tpu_torch import convert
from bipk_tpu_torch.algorithms.apf import StepDraws, build_apf
from bipk_tpu_torch.models import emps as temps
from bipk_tpu_torch.ops import mniw as tmniw
from bipk_tpu_torch.scripts import emps as emps_script
from bipk_tpu_torch.utils import matio

F64 = jnp.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes; one intra-op thread per
    worker keeps the torch side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, want, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def models():
    cfg = jemps.EMPSConfig()
    jmodel = jemps.make_model(cfg, data_dir=None)
    tmodel = convert.emps_model_from_arrays(dataclasses.asdict(cfg), convert.emps_arrays(jmodel))
    return jmodel, tmodel


@pytest.mark.parametrize("kind", ["train", "pulses"])
def test_load_dataset_matches_jax(kind):
    want = jemps.load_dataset(None, kind)
    got = temps.load_dataset(None, kind)
    assert got.synthetic and want.synthetic
    assert got.states.shape == (2400, 2) and got.inputs.shape == (2400, 1)
    for name in ("time", "states", "observations", "inputs"):
        _close(getattr(got, name), getattr(want, name))
    assert got.dt == pytest.approx(want.dt, rel=1e-12)


def test_central_difference_matches_jax():
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(0.5, 1.5, 50))
    x = rng.standard_normal(50)
    _close(temps.central_difference(x, t), jemps.central_difference(x, t))


def test_models_match_jax(models):
    """Both bases (9 functions on the velocity, 729 over the normalized
    ``(q, q', tau)``) and both priors, converted and native."""
    jmodel, tmodel = models
    native = temps.make_model(temps.EMPSConfig(), data_dir=None)
    assert native.baseline_basis.sqrt_eigenvalues.shape == (729, 3)
    for port in (tmodel, native):
        for hb, jhb in ((port.basis, jmodel.basis), (port.baseline_basis, jmodel.baseline_basis)):
            for name in ("sqrt_eigenvalues", "centers", "half_widths", "spectral_density"):
                _close(getattr(hb, name), getattr(jhb, name))
        for p, q in zip((*port.gp.prior, *port.baseline_prior),
                        (*jmodel.gp.prior, *jmodel.baseline_prior)):
            _close(p, q)
        _close(port.x0, jmodel.x0)
        _close(port.p0, jmodel.p0)
    rng = np.random.default_rng(1)
    x = np.stack([rng.uniform(-0.1, 0.4, 40), rng.uniform(-0.15, 0.15, 40)])
    tau = rng.uniform(-100, 100, 40)
    _close(tmodel.gp.basis_fn_bl(_t(x), _t(tau[:1])),
           jax.vmap(lambda s: jmodel.gp.basis_fn(s, tau[:1]))(jnp.asarray(x.T)).T)
    _close(tmodel.baseline_basis_fn(_t(x), _t(tau[None])),
           jax.vmap(jmodel.baseline_basis_fn)(jnp.asarray(x.T), jnp.asarray(tau[:, None])).T)


def test_transition_matches_jax(models):
    jmodel, tmodel = models
    rng = np.random.default_rng(2)
    x = np.stack([rng.uniform(-0.1, 0.4, 30), rng.uniform(-0.15, 0.15, 30)])
    tau, friction = rng.uniform(-100, 100, 30), rng.uniform(-40, 40, 30)
    want = jax.vmap(lambda s, a, f: jemps.transition(s, a, f, 0.01))(
        jnp.asarray(x.T), jnp.asarray(tau), jnp.asarray(friction)).T
    _close(temps.transition(_t(x), _t(tau), _t(friction), 0.01), want)
    want_ssm = jax.vmap(lambda s, a, f: jmodel.ssm.transition(s, a, f))(
        jnp.asarray(x.T), jnp.asarray(tau[:, None]), jnp.asarray(friction[:, None])).T
    _close(tmodel.ssm.transition(_t(x), _t(tau[None]), _t(friction[None])), want_ssm)


def test_validation_rmse_matches_jax(models):
    """Both rollouts on the same GP means: the friction basis fitted to the
    published linear friction, a small full-transition mean."""
    jmodel, tmodel = models
    dq = np.linspace(-0.15, 0.15, 200)
    phi = tmodel.basis.eigen_fn_bl(_t(dq)).numpy()
    w_alg2 = np.linalg.lstsq(phi.T, temps.linear_friction(dq), rcond=None)[0][None]
    w_pgas = 1e-3 * np.random.default_rng(3).standard_normal((2, 729))
    val = jemps.load_dataset(None, "pulses")
    want = jemps.validation_rmse(jmodel, jnp.asarray(w_alg2), jnp.asarray(w_pgas), data=val)
    got = temps.validation_rmse(tmodel, _t(w_alg2), _t(w_pgas), data=temps.load_dataset(None, "pulses"))
    assert np.isfinite(got).all()
    _close(got, want)


def test_apf_steps_match_jax(models):
    """Three steps of the port's ``build_apf`` on EMPS (m = 9, n = 1) from
    the JAX carry with the JAX draws, against the JAX traces."""
    jmodel, tmodel = models
    N, T, lam = 64, 4, 0.999
    Y, U = jmodel.data.observations[:T], jmodel.data.inputs[:T]
    key = jax.random.key(7)
    key_scan, key_init = jax.random.split(key)
    init = JAPFKernel(jmodel.ssm, (jmodel.gp,), F64).init_particles(
        key_init, N, jnp.asarray(U[0]), jnp.asarray(jmodel.x0), jnp.asarray(jmodel.p0))
    draws = []
    for step_key in jax.random.split(key_scan, T - 1):
        k, key_res = jax.random.split(step_key)
        k, key_state = jax.random.split(k)
        k, key_iv = jax.random.split(k)
        ku, kv = jax.random.split(jax.random.split(key_iv, 1)[0])
        draws.append(StepDraws(
            _t(jax.random.uniform(key_res, dtype=F64)).reshape(1),
            _t(jax.random.normal(key_state, (2, N), F64)),
            ((_t(jax.random.uniform(ku, (1, N), F64)), _t(jax.random.uniform(kv, (1, N), F64))),),
        ))
    want = jax.jit(jbuild_apf(jmodel.ssm, (jmodel.gp,), N, lam, dtype=F64))(
        key, Y, U, jmodel.x0, jmodel.p0)

    apf = build_apf(tmodel.ssm, tmodel.gps, N, lam, dtype=torch.float64, device="cpu")
    lw0, state0, iv0, stats0 = init
    carry0 = convert.packed_carry_from_arrays(
        lw0, state0, iv0, [tuple(np.asarray(a) for a in st) for st in stats0],
        torch.float64, "cpu")
    assert carry0[3][0].shape == (tmniw.packed_rows(9, 1), N)
    got = apf.run(carry0, _t(Y), _t(U), draws)
    for name in ("states", "weights", "outputs", "log_likelihood", "ess"):
        _close(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(got.ancestors.numpy(), np.asarray(want.ancestors))
    _close(got.int_vars[0], want.int_vars[0])
    for g, w in zip((*got.stats_mean[0], *got.final_stats[0]),
                    (*want.stats_mean[0], *want.final_stats[0])):
        _close(g, w)


def test_mat_entries_match_jax():
    rng = np.random.default_rng(4)
    Stats = namedtuple("Stats", "T0 T1 T2 T3")
    Result = namedtuple("Result", "states outputs weights log_likelihood stats stats_mean")
    arrays = dict(states=rng.standard_normal((5, 3, 2)), outputs=rng.standard_normal((5, 3, 1)),
                  weights=rng.uniform(size=(5, 3)), log_likelihood=rng.standard_normal((5, 3)))
    stats = [Stats(rng.standard_normal((5, 9, 1)), rng.standard_normal((5, 9, 9)),
                   rng.standard_normal((5, 1, 1)), rng.standard_normal(5)) for _ in range(2)]
    jres = Result(**arrays, stats=stats, stats_mean=stats)
    tres = Result(**{k: _t(v) for k, v in arrays.items()},
                  stats=[Stats(*(_t(x) for x in s)) for s in stats],
                  stats_mean=[Stats(*(_t(x) for x in s)) for s in stats])
    prior = Stats(*(x[0] for x in stats[0]))
    for got, want in (
        (matio.online_entries("online", tres, 1, "_r"), jmatio.online_entries("online", jres, 1, "_r")),
        (matio.offline_entries("offline", tres), jmatio.offline_entries("offline", jres)),
        (matio.prior_entries(Stats(*(_t(x) for x in prior)), "_f"), jmatio.prior_entries(prior, "_f")),
    ):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(matio.to_host(got[k]), np.asarray(want[k]))


def test_entry_point_writes_the_jax_scripts_keys(tmp_path):
    out = tmp_path / "EMPS.mat"
    events = []
    args = emps_script.parse_args(["--cpu", "--particles", "24", "--gibbs-iters", "3",
                                   "--pgas-iters", "3", "--max-steps", "40",
                                   "--data-dir", str(tmp_path), "--out", str(out)])
    emps_script.run(args, hook=lambda event, **info: events.append(event))
    assert events == ["model", "online", "reference", "gibbs-sweep", "gibbs-sweep", "gibbs",
                      "pgas-sweep", "pgas-sweep", "pgas", "validation"]
    mat = scipy.io.loadmat(out)
    assert {k for k in mat if not k.startswith("__")} == emps_script.MAT_KEYS
    assert mat["offline_Sigma_X"].shape == (40, 3, 2)
    assert mat["online_Sigma_X"].shape == (40, 24, 2)
    assert mat["offline_Sigma_X_PGAS"].shape == (40, 3, 2)
    assert mat["basis_plot"].shape == (500, 9)
    assert np.isfinite(mat["RMSE_Alg2"]).all() and np.isfinite(mat["RMSE_PGAS"]).all()


def test_entry_point_runs_parallel_chains(tmp_path, capsys):
    """``--chains 2`` at the size of the test above (baseline skipped),
    with enough sweeps for a summary (4 draws per chain after burn-in):
    one Gibbs-sweep event per iteration for both chains, the friction's
    R-hat and bulk ESS printed and finite, and the ``.mat`` file written
    from chain 0 with the script's keys but the baseline's four."""
    out = tmp_path / "EMPS.mat"
    seen = {}
    args = emps_script.parse_args(["--cpu", "--particles", "24", "--gibbs-iters", "8",
                                   "--max-steps", "40", "--skip-baseline", "--chains", "2",
                                   "--data-dir", str(tmp_path), "--out", str(out)])
    emps_script.run(args, hook=lambda event, **info: seen.setdefault(event, []).append(info))
    assert len(seen["gibbs-sweep"]) == 7
    chains = seen["gibbs"][0]["result"]
    assert chains.states.shape == (2, 40, 8, 2) and chains.int_vars[0].shape == (2, 40, 8, 1)
    said = capsys.readouterr().out
    line = next(ln for ln in said.splitlines() if "friction F:" in ln)
    rhat = float(line.split("R-hat ")[1].split(",")[0])
    ess = float(line.split("ESS ")[1].split()[0])
    assert np.isfinite(rhat) and np.isfinite(ess) and line.endswith("of 8 draws"), line
    assert "8 Gibbs sweeps x 2 chains" in said
    mat = scipy.io.loadmat(out)
    baseline = {"offline_Sigma_X_PGAS", "offline_log_likelihood_PGAS", "RMSE_Alg2", "RMSE_PGAS"}
    assert {k for k in mat if not k.startswith("__")} == emps_script.MAT_KEYS - baseline
    np.testing.assert_array_equal(mat["offline_Sigma_X"], chains.states[0].numpy())
    np.testing.assert_array_equal(mat["offline_T1"], chains.stats[0].T1[0].numpy())


def test_entry_point_raises_on_what_is_not_ported(tmp_path):
    """``--mesh`` is ported: without a process group ``--mesh 1`` runs the
    particle-sharded cSMC on one rank, and more ranks, or a negative
    count, raise; ``tests/test_torch_mesh_scripts.py`` runs ``--mesh 2``
    on two gloo ranks."""
    with pytest.raises(ValueError, match="torchrun --nproc-per-node=2"):
        emps_script.parse_args(["--cpu", "--mesh", "2"])
    with pytest.raises(ValueError, match="number of ranks"):
        emps_script.parse_args(["--cpu", "--mesh", "-1"])
    seen = {}
    args = emps_script.parse_args(["--cpu", "--particles", "24", "--gibbs-iters", "3",
                                   "--max-steps", "40", "--skip-baseline", "--mesh", "1",
                                   "--data-dir", str(tmp_path),
                                   "--out", str(tmp_path / "EMPS.mat")])
    emps_script.run(args, hook=lambda event, **info: seen.setdefault(event, info))
    assert type(seen["gibbs"]["result"].states) is torch.Tensor
    mat = scipy.io.loadmat(tmp_path / "EMPS.mat")
    assert mat["offline_Sigma_X"].shape == (40, 3, 2) and np.isfinite(mat["offline_T1"]).all()

