"""The port's factor pair and dedup gather (plain versions) against the JAX
package's XLA path.

The factor-emitting projection's ``LW`` is held against the JAX
``factorize_scaled_bl`` factor laid out as ``_packed_fp_emit_kernel`` lays
it out; the factor-reusing draw and the dedup gather are held against the
JAX ``draw_update_packed_bl`` on the gathered statistics, the function
both TPU kernels compute. Inputs come from numpy seeds, f64, rtol 1e-10;
the draws are derived from the JAX key as the JAX package derives them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipk_tpu.ops import mniw as jmniw
from bipk_tpu_torch.ops import cuda_kernels as ck
from bipk_tpu_torch.ops import mniw as tmniw

SHAPES = [(20, 1), (9, 1), (6, 2)]  # the JAX factor-reuse test's widths
N = 256


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


def _case(m, n, seed, steps=60, lam=0.99):
    """Packed statistics of forgotten rank-1 updates (numpy, f64), a
    proper MNIW prior and a basis vector per particle."""
    rng = np.random.default_rng(seed)
    scale = np.linspace(0.2, 2.0, m)[:, None]
    st = [np.zeros((m, n, N)), np.zeros((m, m, N)), np.zeros((n, n, N)), np.zeros(N)]
    for _ in range(steps):
        phi = rng.standard_normal((m, N)) * scale
        y = rng.standard_normal((n, N)) + 0.3 * phi[:n]
        new = (phi[:, None] * y[None], phi[:, None] * phi[None], y[:, None] * y[None], 1.0)
        st = [lam * s + d for s, d in zip(st, new)]
    S = np.asarray(jmniw.pack_stats_bl(jmniw.MNIW(*map(jnp.asarray, st))))
    w = rng.standard_normal((m, m + 2))
    prior = tmniw.natural_from_standard(
        rng.standard_normal((n, m)), w @ w.T / (m + 2) + 0.5 * np.eye(m), 1.7 * np.eye(n), 3.0,
    )
    return S, tuple(np.asarray(p) for p in prior), rng.standard_normal((m, N)) * scale


def _systematic(w, u):
    """Sorted systematic ancestors of the weights ``w`` at offset ``u``."""
    cdf = np.cumsum(w) / w.sum()
    return np.minimum(np.searchsorted(cdf, (u + np.arange(w.size)) / w.size, side="right"),
                      w.size - 1).astype(np.int32)


def _ancestors(kind, seed):
    """Sorted ancestors: uneven offspring counts (Dirichlet weights), or
    the vehicle regime of ``_degenerate_sorted_ancestors`` in
    tests/test_pallas_kernels.py: a few heavy particles with long
    offspring runs and a sprinkle of singletons in the gaps."""
    rng = np.random.default_rng(seed)
    if kind == "sorted":
        w = rng.dirichlet(np.full(N, 0.5))
    else:
        w = np.zeros(N)
        w[rng.choice(N, 12, replace=False)] = rng.uniform(size=12) + 0.5
        w[rng.choice(N, int(N * 0.02), replace=False)] += 1.2 / N
    return _systematic(w, rng.uniform())


def _uv(key, n):
    """The uniforms of one draw-update (``mniw.py:877-880``)."""
    key_u, key_v = jax.random.split(key)
    return (_t(jax.random.uniform(key_u, (n, N), jnp.float64)),
            _t(jax.random.uniform(key_v, (n, N), jnp.float64)))


def _jax_lw(chol, white):
    """The JAX factor in ``_packed_fp_emit_kernel``'s layout: rows
    ``[tril(L) row-major, i(i+1)/2 + k | white, tri + i*n + c]``."""
    m, n = white.shape[:2]
    rows = [chol[i, k] for i in range(m) for k in range(i + 1)]
    rows += [white[i, c] for i in range(m) for c in range(n)]
    return np.stack(rows)


@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("with_prior", [True, False])
@pytest.mark.parametrize("lam", [1.0, 0.999])
def test_emitted_factor_matches_jax(m, n, with_prior, lam):
    S, prior, phi = _case(m, n, seed=3)
    jprior = jmniw.MNIW(*map(jnp.asarray, prior)) if with_prior else None
    stats = jmniw.from_flat_bl(jmniw.unpack_stats_bl(jnp.asarray(S), m, n), m, n)
    f = jmniw.factorize_scaled_bl(stats, prior=jprior, lam=lam, use_pallas=False)
    want_fp = jmniw.factorize_project_packed_bl(
        jnp.asarray(S), jnp.asarray(phi), prior=jprior, lam=lam, m=m, n=n, use_pallas=False,
    )
    got = ck.factorize_project_packed(
        _t(S), _t(phi), 0.0, lam, tuple(map(_t, prior[:3])) if with_prior else None,
        m=m, n=n, emit_factor=True,
    )
    assert len(got) == 6 and got[5].shape == (tmniw.lw_rows(m, n), N)
    _close(got[5], _jax_lw(np.asarray(f.chol), np.asarray(f.white_T0)))
    # the emitting projection's small outputs are the plain projection's
    for g, w in zip(got[:5], want_fp[:5]):
        _close(g, w)


@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("kind", ["sorted", "degenerate"])
@pytest.mark.parametrize("wrapper", ["factor", "dedup"])
def test_gathered_draws_match_jax(m, n, kind, wrapper):
    """The factor-reusing draw (``LW`` emitted for the same statistics,
    prior and lambda) and the dedup gather compute the JAX
    ``draw_update_packed_bl`` on ``S[:, ancestors]``."""
    lam = 0.999
    S, prior, phi = _case(m, n, seed=4)
    anc = _ancestors(kind, seed=5)
    key = jax.random.key(13)
    want = jmniw.draw_update_packed_bl(
        key, jnp.take(jnp.asarray(S), jnp.asarray(anc), axis=-1), jnp.asarray(phi),
        prior=jmniw.MNIW(*map(jnp.asarray, prior)), lam=lam, m=m, n=n, use_pallas=False,
    )
    u, v = _uv(key, n)
    blocks, p3 = tuple(map(_t, prior[:3])), float(prior[3])
    if wrapper == "factor":
        LW = ck.factorize_project_packed(_t(S), _t(phi), 0.0, lam, blocks, m=m, n=n,
                                         emit_factor=True)[5]
        got = ck.draw_update_factor_gather_packed_blocks(
            _t(S), LW, torch.as_tensor(anc), _t(phi), u, v, 0.0, lam, blocks, p3, m=m, n=n)
    else:
        got = ck.draw_update_dedup_gather_packed_blocks(
            _t(S), torch.as_tensor(anc), _t(phi), u, v, 0.0, lam, blocks, p3, m=m, n=n)
    for g, w in zip(got, want):
        _close(g, w)


def test_factor_gather_reads_the_factor():
    """The plain factor-reusing draw computes from ``LW``: a perturbed
    factor changes the draw and its log-determinants."""
    m, n, lam = 20, 1, 0.999
    S, prior, phi = _case(m, n, seed=6)
    anc = torch.as_tensor(_ancestors("sorted", seed=7))
    blocks, p3 = tuple(map(_t, prior[:3])), float(prior[3])
    LW = ck.factorize_project_packed(_t(S), _t(phi), 0.0, lam, blocks, m=m, n=n,
                                     emit_factor=True)[5]
    u, v = _uv(jax.random.key(17), n)
    args = (anc, _t(phi), u, v, 0.0, lam, blocks, p3)
    base = ck.draw_update_factor_gather_packed_blocks(_t(S), LW, *args, m=m, n=n)
    ref = ck.draw_update_gather_packed_blocks(_t(S), *args, m=m, n=n)
    for g, w in zip(base, ref):
        _close(g, w)
    bent = ck.draw_update_factor_gather_packed_blocks(_t(S), LW * 1.01, *args, m=m, n=n)
    for k in (1, 2, 3):  # y, logdet_T1, logdet_Psi
        assert not torch.allclose(bent[k], base[k], rtol=1e-6)


def test_emit_factor_beyond_the_factor_width_returns_none():
    """At m = 41 (the oscillator) the plain projection emits no factor,
    as the JAX function returns ``(fp, None)`` where its pair is
    unavailable, and the gather/draw dispatch ignores a factor."""
    m, n = 41, 1
    S, prior, phi = _case(m, n, seed=8, steps=80)
    tprior = tmniw.MNIW(*map(_t, prior[:3]), float(prior[3]))
    fp, lw = tmniw.factorize_project_packed_bl(_t(S), _t(phi), prior=tprior, lam=0.999,
                                               m=m, n=n, emit_factor=True)
    assert lw is None
    for g, w in zip(fp, tmniw.factorize_project_packed_bl(_t(S), _t(phi), prior=tprior,
                                                          lam=0.999, m=m, n=n)):
        if w is not None:
            _close(g, w)


@pytest.mark.parametrize("m,factor,dedup,runs", [
    (20, True, False, "draw_update_factor_gather_packed_blocks"),
    (20, True, True, "draw_update_factor_gather_packed_blocks"),  # the factor wins
    (20, False, True, "draw_update_dedup_gather_packed_blocks"),
    (20, False, False, "draw_update_gather_packed_blocks"),
    (41, True, True, "draw_update_gather_packed_blocks"),  # no pair, no dedup above 24
])
def test_gather_dispatch_follows_jax(monkeypatch, m, factor, dedup, runs):
    """``mniw.draw_update_gather_packed_bl`` picks the kernel as the JAX
    dispatch does without its lane windows: factor, then dedup, then the
    gather/draw kernel, each within its widths."""
    called = []
    for name in ("draw_update_factor_gather_packed_blocks",
                 "draw_update_dedup_gather_packed_blocks",
                 "draw_update_gather_packed_blocks"):
        monkeypatch.setattr(ck, name, lambda *a, _name=name, **k: called.append(_name))
    S = torch.zeros((tmniw.packed_rows(m, 1), 4), dtype=torch.float64)
    LW = torch.zeros((tmniw.lw_rows(m, 1), 4), dtype=torch.float64) if factor else None
    tmniw.draw_update_gather_packed_bl(None, None, S, None, None, m=m, n=1,
                                       factor=LW, dedup=dedup)
    assert called == [runs]
