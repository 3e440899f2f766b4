"""The port's plain PyTorch ops against the JAX package's XLA path.

Each case feeds the same float64 inputs, made from a numpy seed, to the
JAX function (``use_pallas=False``; the conftest pins JAX to the CPU with
x64) and to its counterpart in ``bipk_tpu_torch`` on the CPU, where every
kernel wrapper computes its plain version. The arithmetic is the same up
to summation order, so the tolerance is rtol 1e-10. Random draws are
derived from the JAX key exactly as the JAX package derives them and
handed to the port, so the draw-update comparisons are exact too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipk_tpu.models import vehicle as jveh
from bipk_tpu.ops import basis as jbasis
from bipk_tpu.ops import batched_linalg as jbla
from bipk_tpu.ops import gaussian as jgauss
from bipk_tpu.ops import integrators as jint
from bipk_tpu.ops import mniw as jmniw
from bipk_tpu.ops import resampling as jres
from bipk_tpu_torch.models import vehicle as tveh
from bipk_tpu_torch.ops import basis as tbasis
from bipk_tpu_torch.ops import batched_linalg as tbla
from bipk_tpu_torch.ops import cuda_kernels as ck
from bipk_tpu_torch.ops import gaussian as tgauss
from bipk_tpu_torch.ops import integrators as tint
from bipk_tpu_torch.ops import mniw as tmniw
from bipk_tpu_torch.ops import resampling as tres

RTOL = 1e-10


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
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=rtol, atol=atol
    )


def _stats(rng, m, n, N, steps=60, lam=0.99):
    """Accumulated, forgotten rank-1 statistics (structured batch-last,
    numpy): SPD ``T1`` with a realistic spread of eigenvalues."""
    T0 = np.zeros((m, n, N))
    T1 = np.zeros((m, m, N))
    T2 = np.zeros((n, n, N))
    T3 = np.zeros(N)
    for _ in range(steps):
        phi = rng.standard_normal((m, N)) * np.linspace(0.2, 2.0, m)[:, None]
        y = rng.standard_normal((n, N)) + 0.3 * phi[:n]
        T0 = lam * T0 + phi[:, None] * y[None]
        T1 = lam * T1 + phi[:, None] * phi[None]
        T2 = lam * T2 + y[:, None] * y[None]
        T3 = lam * T3 + 1.0
    return T0, T1, T2, T3


def _prior(rng, m, n):
    """A proper MNIW prior in natural form (numpy)."""
    w = rng.standard_normal((m, m + 2))
    return tveh.natural_from_standard(
        rng.standard_normal((n, m)), w @ w.T / (m + 2) + 0.5 * np.eye(m),
        1.7 * np.eye(n), 3.0,
    )


SHAPES = [(20, 1), (5, 2), (40, 1), (41, 1)]  # the tiled widths and the cs widths
N = 64  # one particle count for every JAX reference: XLA compiles per shape


@pytest.mark.parametrize("m,n", SHAPES)
def test_pack_unpack_round_trips(m, n):
    rng = np.random.default_rng(m + n)
    st = _stats(rng, m, n, N)
    want = np.asarray(jmniw.pack_stats_bl(jmniw.MNIW(*map(jnp.asarray, st))))
    got = tmniw.pack_stats_bl(tmniw.MNIW(*map(_t, st)))
    assert got.shape == (tmniw.packed_rows(m, n), N) == want.shape
    _close(got, want)
    for g, w in zip(tmniw.unpack_stats_bl(got, m, n),
                    jmniw.unpack_stats_bl(jnp.asarray(want), m, n)):
        _close(g, w)
    red = want @ rng.random(N)
    for g, w in zip(tmniw.unpack_reduced(_t(red), m, n),
                    jmniw.unpack_reduced(jnp.asarray(red), m, n)):
        _close(g, w)
    # leading batch axes unpack like a stack of single columns
    batched = tmniw.unpack_reduced(_t(np.stack([red, 2 * red])), m, n)
    _close(batched.T1[1], 2 * np.asarray(jmniw.unpack_reduced(jnp.asarray(red), m, n).T1))


def _packed_case(m, n, N, seed):
    rng = np.random.default_rng(seed)
    st = _stats(rng, m, n, N)
    S = np.asarray(jmniw.pack_stats_bl(jmniw.MNIW(*map(jnp.asarray, st))))
    phi = rng.standard_normal((m, N))
    return S, phi, _prior(rng, m, n)


@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("with_prior", [True, False])
def test_factorize_project_packed_matches_jax(m, n, with_prior):
    S, phi, prior = _packed_case(m, n, N, seed=3)
    lam = 0.999
    want = jmniw.factorize_project_packed_bl(
        jnp.asarray(S), jnp.asarray(phi),
        prior=jmniw.MNIW(*map(jnp.asarray, prior)) if with_prior else None,
        lam=lam, m=m, n=n, use_pallas=False,
    )
    got = tmniw.factorize_project_packed_bl(
        _t(S), _t(phi),
        prior=tmniw.MNIW(*map(_t, prior)) if with_prior else None,
        lam=lam, m=m, n=n,
    )
    for g, w in zip(got, want):
        _close(g, w)
    # the kernel wrapper's CPU branch is the same plain version
    wrapped = ck.factorize_project_packed(
        _t(S), _t(phi), 0.0, lam, tuple(map(_t, prior[:3])) if with_prior else None,
        m=m, n=n,
    )
    for g, w in zip(wrapped, want[:5]):
        _close(g, w)


def _uv(key, n, N):
    """The uniforms of one draw-update: ``mniw.py:877-880`` (and the XLA
    path's ``student_t``) split the key into ``key_u, key_v``."""
    key_u, key_v = jax.random.split(key)
    u = jax.random.uniform(key_u, (n, N), jnp.float64)
    v = jax.random.uniform(key_v, (n, N), jnp.float64)
    return _t(u), _t(v)


@pytest.mark.parametrize("m,n", SHAPES)
def test_draw_update_packed_matches_jax(m, n):
    S, phi, prior = _packed_case(m, n, N, seed=4)
    key = jax.random.key(11)
    want = jmniw.draw_update_packed_bl(
        key, jnp.asarray(S), jnp.asarray(phi),
        prior=jmniw.MNIW(*map(jnp.asarray, prior)), lam=0.999, m=m, n=n,
        use_pallas=False,
    )
    u, v = _uv(key, n, N)
    got = ck.draw_update_packed_blocks(
        _t(S), _t(phi), u, v, 0.0, 0.999, tuple(map(_t, prior[:3])),
        p3=float(prior[3]), m=m, n=n,
    )
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("m,n", SHAPES)
def test_draw_update_gather_packed_matches_jax(m, n):
    N_in, N_out = 80, N
    S, _, prior = _packed_case(m, n, N_in, seed=5)
    rng = np.random.default_rng(6)
    anc = np.sort(rng.integers(0, N_in, N_out)).astype(np.int32)
    phi = rng.standard_normal((m, N_out))
    key = jax.random.key(12)
    want = jmniw.draw_update_gather_packed_bl(
        key, jnp.asarray(S), jnp.asarray(anc), jnp.asarray(phi),
        prior=jmniw.MNIW(*map(jnp.asarray, prior)), lam=0.999, m=m, n=n,
        use_pallas=False,
    )
    u, v = _uv(key, n, N_out)
    got = ck.draw_update_gather_packed_blocks(
        _t(S), torch.as_tensor(anc), _t(phi), u, v, 0.0, 0.999,
        tuple(map(_t, prior[:3])), p3=float(prior[3]), m=m, n=n,
    )
    for g, w in zip(got, want):
        _close(g, w)


def test_student_t_matches_jax():
    key = jax.random.key(3)
    df = jnp.asarray(np.linspace(0.5, 40.0, N))
    want = jgauss.student_t(key, df, (2, N), jnp.float64)
    u, v = _uv(key, 2, N)
    _close(tgauss.student_t(_t(df), u, v), want)


@pytest.mark.parametrize("size", [1, 7, 257, 1000])
def test_systematic_matches_jax(size):
    rng = np.random.default_rng(size)
    for trial in range(4):
        key = jax.random.key(100 * size + trial)
        w = np.exp(3.0 * rng.standard_normal(size))
        if trial == 1:
            w[rng.random(size) < 0.8] = 0.0  # degenerate, mostly zero mass
        if trial == 2:
            w[:] = 0.0  # zero mass -> uniform fallback
        want = np.asarray(jres.systematic(key, jnp.asarray(w)))
        u = _t(jax.random.uniform(key, dtype=jnp.float64))
        got = ck.systematic_ancestors_blocks(_t(w), u, size).numpy()
        assert got.dtype == np.int32
        assert np.all(np.diff(got) >= 0)
        # equal ancestors up to one slot at exact cdf/grid ties
        assert np.sum(got != want) <= 1, (trial, np.flatnonzero(got != want))


def test_systematic_mass_at_the_ends():
    for idx in (0, 63):
        w = torch.zeros(64, dtype=torch.float64)
        w[idx] = 1.0
        got = tres.systematic(w, torch.tensor(0.37, dtype=torch.float64))
        assert torch.all(got == idx)


def test_batched_linalg_matches_jax():
    rng = np.random.default_rng(9)
    m, N = 6, 11
    W = rng.standard_normal((m, m + 3, N))
    A = np.einsum("ikn,jkn->ijn", W, W) + 0.1 * np.eye(m)[:, :, None]
    b = rng.standard_normal((m, N))
    b3 = rng.standard_normal((m, 2, N))
    L = tbla.chol_lower_bl(_t(A))
    _close(L, jbla.chol_lower_bl(jnp.asarray(A)))
    jL = jnp.asarray(L.numpy())
    _close(tbla.solve_lower_bl(L, _t(b)), jbla.solve_lower_bl(jL, jnp.asarray(b)))
    _close(tbla.solve_lower_bl(L, _t(b3)), jbla.solve_lower_bl(jL, jnp.asarray(b3)))
    _close(tbla.solve_lower_t_bl(L, _t(b)), jbla.solve_lower_t_bl(jL, jnp.asarray(b)))
    _close(tbla.logdet_from_chol_bl(L), jbla.logdet_from_chol_bl(jL))
    Lc = np.linalg.cholesky(A[:, :, 0])  # constant factor, batched rhs
    _close(tbla.solve_lower_bl(_t(Lc), _t(b)), jbla.solve_lower_bl(jnp.asarray(Lc), jnp.asarray(b)))


def test_hilbert_basis_matches_jax():
    rad = np.pi / 180.0
    args = (20, np.array([-30 * rad, 30 * rad]), 2 * rad, 50.0)
    jb = jbasis.make_hilbert_basis(*args, idx_start=2, idx_step=2)
    tb = tbasis.make_hilbert_basis(*args, idx_start=2, idx_step=2)
    _close(tb.sqrt_eigenvalues, jb.sqrt_eigenvalues)
    _close(tb.spectral_density, jb.spectral_density)
    x = np.random.default_rng(1).uniform(-0.4, 0.4, 300)
    _close(tb.eigen_fn_bl(_t(x)), jb.eigen_fn_bl(jnp.asarray(x)))
    # 2-D domain: product of per-dimension eigenfunctions
    dom = np.array([[-1.0, 2.0], [0.0, 3.0]])
    jb2 = jbasis.make_hilbert_basis(9, dom, [0.5, 0.7], 2.0)
    tb2 = tbasis.make_hilbert_basis(9, dom, [0.5, 0.7], 2.0)
    x2 = np.random.default_rng(2).uniform(0.0, 2.0, (2, 40))
    _close(tb2.eigen_fn_bl(_t(x2)), jb2.eigen_fn_bl(jnp.asarray(x2)))
    _close(tb2.spectral_density, jb2.spectral_density)


def test_rk4_and_vehicle_physics_match_jax():
    rng = np.random.default_rng(4)
    N = 33
    x = rng.standard_normal((2, N)) * 0.05
    u = np.array([0.08, 11.0])
    mu_f, mu_r = rng.uniform(-0.9, 0.9, (2, N))
    for g, w in zip(tveh.side_slip(_t(x), _t(u)), jveh.side_slip(jnp.asarray(x), jnp.asarray(u))):
        _close(g, w)
    alpha = rng.uniform(-0.5, 0.5, N)
    _close(tveh.mu_y_true(_t(alpha)), jveh.mu_y_true(jnp.asarray(alpha)))
    jtrans = jax.vmap(lambda xx, f, r: jveh.transition(xx, jnp.asarray(u), f, r, 0.02),
                      in_axes=(1, 0, 0), out_axes=1)
    _close(tveh.transition(_t(x), _t(u), _t(mu_f), _t(mu_r), 0.02),
           jtrans(jnp.asarray(x), jnp.asarray(mu_f), jnp.asarray(mu_r)))
    jobs = jax.vmap(lambda xx, f, r: jveh.observe(xx, jnp.asarray(u), f, r),
                    in_axes=(1, 0, 0), out_axes=1)
    _close(tveh.observe(_t(x), _t(u), _t(mu_f), _t(mu_r)),
           jobs(jnp.asarray(x), jnp.asarray(mu_f), jnp.asarray(mu_r)))

    def rhs(z, a):
        return jnp.stack([z[1], -a * jnp.sin(z[0])]) if isinstance(z, jax.Array) \
            else torch.stack([z[1], -a * torch.sin(z[0])])

    z0 = rng.standard_normal((2, N))
    _close(tint.rk4_step(rhs, _t(z0), 0.1, 2.0),
           jint.rk4_step(rhs, jnp.asarray(z0), 0.1, 2.0))


def test_vehicle_model_matches_jax():
    cfg = tveh.VehicleConfig()
    tm = tveh.make_model(cfg)
    jm = jveh.make_model(jveh.VehicleConfig())
    for tg, jg in zip(tm.gps, jm.gps):
        for a, b in zip(tg.prior, jg.prior):
            _close(a, b)
    _close(tveh.steering_profile(cfg), jveh.steering_profile(jveh.VehicleConfig()))
    assert cfg.n_steps == jveh.VehicleConfig().n_steps
