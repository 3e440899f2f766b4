"""The port's unpacked-statistics functions against the JAX package's XLA
path (``use_pallas=False``), on the CPU in float64, rtol 1e-10.

- the plain versions of the four unpacked kernels (``cuda_kernels.
  factorize_blocks``, ``factorize_project_blocks``, ``project_blocks``,
  ``log_base_measure_logdets``, which compute them on CPU tensors) and the
  ``mniw`` entry points that dispatch to them, for structured and flat
  leaves, with a prior and lambda, n = 1 and 2;
- ``factor_mean_at_bl``, ``sample_predictive_bl`` (the JAX draws' uniforms
  handed over) and ``log_base_measure_from_factor_bl``;
- the unpacked ``APFKernel`` methods at the vehicle's m = 20;
- on CPU tensors no wrapper counts a launch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipk_tpu.algorithms.apf import APFKernel as JAPFKernel
from bipk_tpu.models import vehicle as jveh
from bipk_tpu.ops import batched_linalg as jbla
from bipk_tpu.ops import cholup as jcholup
from bipk_tpu.ops import mniw as jmniw
from bipk_tpu_torch import convert
from bipk_tpu_torch.algorithms.apf import APFKernel
from bipk_tpu_torch.ops import cholup as tcholup
from bipk_tpu_torch.ops import cuda_kernels as ck
from bipk_tpu_torch.ops import mniw as tmniw

F64 = jnp.float64
RTOL = 1e-10
SHAPES = [(20, 1), (9, 2), (41, 1)]  # the vehicle's width, n = 2, the <48> width
N = 48


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


def _close(got, want, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _stats(rng, m, n, N, steps=60, lam=0.99):
    """Accumulated, forgotten rank-1 statistics (structured batch-last,
    numpy), SPD ``T1``."""
    T0, T1, T2, T3 = np.zeros((m, n, N)), np.zeros((m, m, N)), np.zeros((n, n, N)), np.zeros(N)
    for _ in range(steps):
        phi = rng.standard_normal((m, N)) * np.linspace(0.2, 2.0, m)[:, None]
        y = rng.standard_normal((n, N)) + 0.3 * phi[:n]
        T0 = lam * T0 + phi[:, None] * y[None]
        T1 = lam * T1 + phi[:, None] * phi[None]
        T2 = lam * T2 + y[:, None] * y[None]
        T3 = lam * T3 + 1.0
    return T0, T1, T2, T3


def _prior(rng, m, n):
    w = rng.standard_normal((m, m + 2))
    return jmniw.natural_from_standard(
        rng.standard_normal((n, m)), w @ w.T / (m + 2) + 0.5 * np.eye(m), 1.7 * np.eye(n), 3.0)


def _case(m, n, seed):
    rng = np.random.default_rng(seed)
    st = _stats(rng, m, n, N)
    return st, rng.standard_normal((m, N)), tuple(np.asarray(p) for p in _prior(rng, m, n))


def _flat(st, m, n):
    return (st[0].reshape(m * n, -1), st[1].reshape(m * m, -1), st[2].reshape(n * n, -1), st[3])


def _jprior(prior):
    return None if prior is None else jmniw.MNIW(*map(jnp.asarray, prior))


def _tprior(prior):
    return None if prior is None else tmniw.MNIW(*map(_t, prior))


@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("with_prior,lam", [(True, 0.999), (False, 1.0)])
def test_factorize_blocks_plain_matches_jax(m, n, with_prior, lam):
    st, _, prior = _case(m, n, seed=m + n)
    prior = prior if with_prior else None
    want = jmniw.factorize_scaled_bl(jmniw.MNIW(*map(jnp.asarray, st)), prior=_jprior(prior),
                                     lam=lam, use_pallas=False)
    blocks = None if prior is None else tuple(map(_t, prior[:3]))
    got = ck.factorize_blocks(*map(_t, st[:3]), 0.0, lam, blocks)
    for g, w in zip(got, want[:3]):
        _close(g, w)
    # the entry points on CPU tensors: the same plain version
    entry = tmniw.factorize_scaled_bl(tmniw.MNIW(*map(_t, st)), prior=_tprior(prior), lam=lam)
    for g, w in zip(entry, want):
        _close(g, w)
    if prior is None and lam == 1.0:
        for g, w in zip(tmniw.factorize_bl(tmniw.MNIW(*map(_t, st))),
                        jmniw.factorize_bl(jmniw.MNIW(*map(jnp.asarray, st)), use_pallas=False)):
            _close(g, w)


@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("flat", [False, True])
def test_factorize_project_blocks_plain_matches_jax(m, n, flat):
    st, phi, prior = _case(m, n, seed=2 * m + n)
    lam = 0.999
    leaves = _flat(st, m, n) if flat else st
    want = jmniw.factorize_project_bl(jmniw.MNIW(*map(jnp.asarray, leaves)), jnp.asarray(phi),
                                      prior=_jprior(prior), lam=lam, use_pallas=False)
    kw = dict(m=m, n=n) if flat else {}
    got = ck.factorize_project_blocks(*map(_t, leaves[:3]), _t(phi), 0.0, lam,
                                      tuple(map(_t, prior[:3])), **kw)
    for g, w in zip(got, want[:5]):
        _close(g, w)
    entry = tmniw.factorize_project_bl(tmniw.MNIW(*map(_t, leaves)), _t(phi),
                                       prior=_tprior(prior), lam=lam)
    for g, w in zip(entry, want):
        _close(g, w)


@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("flat", [False, True])
def test_log_base_measure_logdets_plain_matches_jax(m, n, flat):
    st, _, prior = _case(m, n, seed=3 * m + n)
    nat = tuple(s + (p[..., None] if s.ndim > 1 else p) for s, p in zip(st, prior))
    leaves = _flat(nat, m, n) if flat else nat
    kw = dict(m=m, n=n) if flat else {}
    jf = jmniw.factorize_bl(jmniw.MNIW(*map(jnp.asarray, nat)), use_pallas=False)
    psi = np.asarray(jf.row_scale)
    want_ld1 = np.asarray(jbla.logdet_from_chol_bl(jf.chol))
    want_ldp = np.log(psi[0, 0] if n == 1 else psi[0, 0] * psi[1, 1] - psi[0, 1] * psi[1, 0])
    got = ck.log_base_measure_logdets(*map(_t, leaves[:3]), 0.0, **kw)
    _close(got[0], want_ld1)
    _close(got[1], want_ldp)
    want = jmniw.log_base_measure_bl(jmniw.MNIW(*map(jnp.asarray, leaves)), use_pallas=False,
                                     m=m, n=n)
    _close(tmniw.log_base_measure_bl(tmniw.MNIW(*map(_t, leaves)), **kw), want)


@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("views", [False, True])
def test_project_blocks_plain_matches_jax(m, n, views):
    """From a factor, contiguous or as views of an augmented factor (the
    rank-1 cSMC's ``aug_to_factor``): the mean of ``factor_mean_at_bl`` and
    the column scale ``|L^{-1} phi|^2 + 1``."""
    st, phi, _ = _case(m, n, seed=4 * m + n)
    jnat = jmniw.MNIW(*map(jnp.asarray, st))
    if views:
        jF, jdf = jcholup.aug_factorize_bl(jnat)
        jfac = jcholup.aug_to_factor(jF, jdf, m)
        fac = tcholup.aug_to_factor(_t(jF), _t(jdf), m)
    else:
        jfac = jmniw.factorize_bl(jnat, use_pallas=False)
        fac = tmniw.MNIWFactor(*map(_t, jfac))
    mean, col = ck.project_blocks(fac.chol, fac.white_T0, _t(phi))
    _close(mean, jmniw.factor_mean_at_bl(jfac, jnp.asarray(phi), use_pallas=False))
    v = np.asarray(jbla.solve_lower_bl(jfac.chol, jnp.asarray(phi)))
    _close(col, (v * v).sum(0) + 1.0)
    _close(tmniw.factor_mean_at_bl(fac, _t(phi)), mean, rtol=0, atol=0)


@pytest.mark.parametrize("m,n", SHAPES)
def test_sample_predictive_and_base_measure_from_factor_match_jax(m, n):
    st, phi, prior = _case(m, n, seed=5 * m + n)
    jfac = jmniw.factorize_scaled_bl(jmniw.MNIW(*map(jnp.asarray, st)), prior=_jprior(prior),
                                     use_pallas=False)
    fac = tmniw.MNIWFactor(*map(_t, jfac))
    key = jax.random.key(m + n)
    key_u, key_v = jax.random.split(key)  # the XLA path's student_t
    u, v = (_t(jax.random.uniform(k, (n, N), F64)) for k in (key_u, key_v))
    want = jmniw.sample_predictive_bl(key, jfac, jnp.asarray(phi), use_pallas=False)
    _close(tmniw.sample_predictive_bl(fac, _t(phi), u, v), want)
    _close(tmniw.log_base_measure_from_factor_bl(fac), jmniw.log_base_measure_from_factor_bl(jfac))


# ---------------------------------------------------------------------------
# The unpacked APFKernel methods, vehicle model (two GPs, m = 20, n = 1).
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kernels():
    cfg = jveh.VehicleConfig(t_end=0.1)
    jmodel = jveh.make_model(cfg)
    _, Y, _, _, U = jveh.simulate(jax.random.key(3), cfg, dtype=F64)
    tmodel = convert.vehicle_model_from_arrays(dataclasses.asdict(cfg),
                                               convert.vehicle_arrays(jmodel))
    jk = JAPFKernel(jmodel.ssm, jmodel.gps, F64)
    tk = APFKernel(tmodel.ssm, tmodel.gps, torch.float64, "cpu")
    rng = np.random.default_rng(7)
    carry = dict(
        stats=tuple(_stats(rng, 20, 1, N) for _ in range(2)),
        state=np.stack([0.05 * rng.standard_normal(N), 0.2 * rng.standard_normal(N)]),
        ivs=tuple(0.3 * rng.standard_normal((1, N)) for _ in range(2)),
        log_w=np.log(rng.random(N)),
        anc=np.sort(rng.integers(0, N, N)).astype(np.int32),
    )
    return jk, tk, np.asarray(Y), np.asarray(U), carry


def _tstats(stats):
    return tuple(tmniw.MNIW(*map(_t, st)) for st in stats)


def _jstats(stats):
    return tuple(jmniw.MNIW(*map(jnp.asarray, st)) for st in stats)


def _tree_close(got, want):
    g_leaves = [x for x in jax.tree_util.tree_leaves(got, is_leaf=lambda x: x is None)
                if x is not None]
    w_leaves = [x for x in jax.tree_util.tree_leaves(want, is_leaf=lambda x: x is None)
                if x is not None]
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        _close(g, w)


def _uvs(key):
    """Per GP the uniforms of a keyed draw: ``jax.random.split(key, 2)``,
    then ``student_t``'s split."""
    out = []
    for k in jax.random.split(key, 2):
        ku, kv = jax.random.split(k)
        out.append((_t(jax.random.uniform(ku, (1, N), F64)), _t(jax.random.uniform(kv, (1, N), F64))))
    return tuple(out)


def test_factorize_all_auxiliary_and_projected_match_jax(kernels):
    jk, tk, Y, U, c = kernels
    lam = 0.999
    jf = jk.factorize_all(_jstats(c["stats"]), lam)
    tf = tk.factorize_all(_tstats(c["stats"]), lam)
    _tree_close(tf, jf)
    args = (c["state"], c["ivs"])
    want = jk.auxiliary(jnp.asarray(args[0]), tuple(map(jnp.asarray, args[1])), jf,
                        jnp.asarray(U[0]), jnp.asarray(U[1]), jnp.asarray(Y[1]),
                        jnp.asarray(c["log_w"]))
    got = tk.auxiliary(_t(args[0]), tuple(map(_t, args[1])), tf, _t(U[0]), _t(U[1]), _t(Y[1]),
                       _t(c["log_w"]))
    _tree_close(got, want)
    want = jk.auxiliary_fused(_jstats(c["stats"]), lam, jnp.asarray(args[0]),
                              tuple(map(jnp.asarray, args[1])), jnp.asarray(U[0]),
                              jnp.asarray(U[1]), jnp.asarray(Y[1]), jnp.asarray(c["log_w"]))
    got = tk.auxiliary_fused(_tstats(c["stats"]), lam, _t(args[0]), tuple(map(_t, args[1])),
                             _t(U[0]), _t(U[1]), _t(Y[1]), _t(c["log_w"]))
    _tree_close(got, want)


@pytest.mark.parametrize("flat", [False, True])
def test_draws_and_update_stats_match_jax(kernels, flat):
    jk, tk, _, U, c = kernels
    lam = 0.999
    key = jax.random.key(21)
    stats = tuple(_flat(st, 20, 1) for st in c["stats"]) if flat else c["stats"]
    state = c["state"]
    want_iv, want_basis = jk.draw_int_vars_fused(key, _jstats(stats), lam, jnp.asarray(state),
                                                 jnp.asarray(U[1]))
    got_iv, got_basis = tk.draw_int_vars_fused(_uvs(key), _tstats(stats), lam, _t(state),
                                               _t(U[1]))
    _tree_close((got_iv, got_basis), (want_iv, want_basis))
    jf = jk.factorize_all(_jstats(c["stats"]))
    want = jk.draw_int_vars(key, jf, jnp.asarray(state), jnp.asarray(U[1]))
    got = tk.draw_int_vars(_uvs(key), tk.factorize_all(_tstats(c["stats"])), _t(state), _t(U[1]))
    _tree_close(got, want)
    for lam_u in (1.0, lam):
        want = jk.update_stats(_jstats(stats), want_iv, want_basis, lam=lam_u)
        got = tk.update_stats(_tstats(stats), got_iv, got_basis, lam=lam_u)
        _tree_close(got, want)


def test_gathers_and_draw_update_all_packed_match_jax(kernels):
    jk, tk, _, U, c = kernels
    anc = c["anc"]
    want = jk.gather(_jstats(c["stats"]), jnp.asarray(anc))
    got = tuple(tk.gather(st, torch.as_tensor(anc)) for st in _tstats(c["stats"]))
    _tree_close(got, want)
    assert isinstance(got[0], tmniw.MNIW)
    Ss = tuple(np.asarray(jmniw.pack_stats_bl(st)) for st in _jstats(c["stats"]))
    want_g = jk.gather_packed(tuple(map(jnp.asarray, Ss)), jnp.asarray(anc))
    got_g = tk.gather_packed(tuple(map(_t, Ss)), torch.as_tensor(anc))
    _tree_close(got_g, want_g)
    key = jax.random.key(22)
    want = jk.draw_update_all_packed(key, want_g, 0.999, jnp.asarray(c["state"]),
                                     jnp.asarray(U[1]))
    got = tk.draw_update_all_packed(_uvs(key), got_g, 0.999, _t(c["state"]), _t(U[1]))
    _tree_close(got, want)


def test_unpacked_wrappers_count_no_launch_on_the_cpu():
    st, phi, prior = _case(20, 1, seed=9)
    T0, T1, T2 = map(_t, st[:3])
    ck.reset_launch_counts()
    chol, white, _ = ck.factorize_blocks(T0, T1, T2, 0.0)
    ck.factorize_project_blocks(T0, T1, T2, _t(phi), 0.0)
    ck.project_blocks(chol, white, _t(phi))
    ck.log_base_measure_logdets(T0, T1, T2, 0.0)
    tmniw.log_base_measure_bl(tmniw.MNIW(*map(_t, st)))
    assert sum(ck.launch_counts().values()) == 0
