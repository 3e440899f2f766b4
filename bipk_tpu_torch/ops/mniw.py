"""Matrix-normal-inverse-Wishart (MNIW) algebra over the packed
batch-last statistics (port of the packed subset of
``bipk_tpu/ops/mniw.py``).

Natural parameters / sufficient statistics ``(T0 (m, n), T1 (m, m),
T2 (n, n), T3 ())`` per particle, carried as ONE packed matrix per GP with
rows ``[T0 | col-major tril(T1) | tril(T2) | T3]`` and the particle axis
last — the JAX package's layout, so arrays compare element for element.

The packed entry points :func:`factorize_project_packed_bl` (with the
factor ``LW`` it emits), :func:`draw_update_packed_bl` and
:func:`draw_update_factor_gather_packed_bl` are the plain PyTorch versions
of the CUDA kernels in :mod:`bipk_tpu_torch.ops.cuda_kernels`;
:func:`draw_update_gather_packed_bl` picks the gather/draw kernel (or its
plain version) as the JAX dispatch does.

The unpacked entry points :func:`factorize_bl`, :func:`factorize_scaled_bl`,
:func:`factorize_project_bl`, :func:`log_base_measure_bl`,
:func:`factor_mean_at_bl` and :func:`sample_predictive_bl` launch the
unpacked kernels on CUDA tensors (float32, m <= 48, n <= 2; any other
CUDA tensor raises) and compute their plain versions on CPU tensors or
with ``plain=True``. The
plain versions of the packed kernels call the private plain cores
(``_factorize_bl_plain`` and the like), never these entry points, so a
plain version never launches a kernel. Every random draw is an input
(``u, v`` uniforms), so each function is deterministic.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from bipk_tpu_torch.ops import batched_linalg as bla
from bipk_tpu_torch.ops.gaussian import student_t


class MNIW(NamedTuple):
    """Natural parameters (or additive sufficient statistics) of an MNIW."""

    T0: torch.Tensor  # (m, n)
    T1: torch.Tensor  # (m, m)
    T2: torch.Tensor  # (n, n)
    T3: torch.Tensor  # ()


class MNIWFactor(NamedTuple):
    """Cholesky factorization of ``sym(T1)`` with derived quantities."""

    chol: torch.Tensor  # (m, m, N) lower
    white_T0: torch.Tensor  # (m, n, N)
    row_scale: torch.Tensor  # (n, n, N) = T2 - white^T white
    df: torch.Tensor  # (N,)


class ProjectedFactor(NamedTuple):
    """Per-particle matrix-t predictive pieces at one basis vector plus the
    log-determinants of the factored MNIW: ``mean (n, N)``, ``col_scale
    (N,)``, ``row_scale (n, n, N)``, ``logdet_T1 (N,)``, ``logdet_Psi
    (N,)``, ``df (N,)``."""

    mean: torch.Tensor
    col_scale: torch.Tensor
    row_scale: torch.Tensor
    logdet_T1: torch.Tensor
    logdet_Psi: torch.Tensor
    df: torch.Tensor


def _default_jitter(dtype) -> float:
    """Relative Cholesky jitter: none in f64, ``1e-9`` otherwise."""
    return 0.0 if dtype == torch.float64 else 1e-9


# ---------------------------------------------------------------------------
# Unbatched helpers: priors and posterior summaries.
# ---------------------------------------------------------------------------


def chol_spd(A: torch.Tensor, jitter: float | None = None) -> torch.Tensor:
    """Lower Cholesky of one SPD ``(m, m)`` matrix with the dtype's
    relative jitter ``jitter * trace/m`` on the diagonal. No host
    synchronisation: a failed factorization shows as NaN."""
    if jitter is None:
        jitter = _default_jitter(A.dtype)
    if jitter:
        scale = torch.diagonal(A).sum() / A.shape[-1]
        A = A + (jitter * scale) * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.linalg.cholesky_ex(A)[0]


def solve_spd(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``A X = B`` for SPD ``A`` through :func:`chol_spd`; ``B`` is
    ``(m,)`` or ``(m, r)``."""
    rhs = B if B.dim() == 2 else B[:, None]
    X = torch.cholesky_solve(rhs, chol_spd(A))
    return X if B.dim() == 2 else X[:, 0]


def natural_from_standard(mean, col_cov, row_scale, df) -> MNIW:
    """Standard MNIW parameters -> natural parameters (numpy, float64):
    ``T0 = V^{-1} M^T``, ``T1 = V^{-1}``, ``T2 = M T0 + Psi``, ``T3 =
    df``. The priors are built on the host, once."""
    mean = np.atleast_2d(np.asarray(mean, np.float64))
    col_cov = np.asarray(col_cov, np.float64)
    T0 = np.linalg.solve(col_cov, mean.T)
    T1 = np.linalg.solve(col_cov, np.eye(col_cov.shape[0]))
    T2 = mean @ T0 + np.atleast_2d(np.asarray(row_scale, np.float64))
    return MNIW(T0, T1, T2, np.asarray(float(df)))


def standard_from_natural(nat: MNIW):
    """Natural parameters (unbatched tensors) -> standard parameters
    ``(mean (n, m), col_cov (m, m), row_scale (n, n), df)``."""
    L = chol_spd(nat.T1)
    eye = torch.eye(nat.T1.shape[0], dtype=nat.T1.dtype, device=nat.T1.device)
    col_cov = torch.cholesky_solve(eye, L)
    mean = torch.cholesky_solve(nat.T0, L).T
    return mean, col_cov, nat.T2 - mean @ nat.T0, nat.T3


def posterior_mean(nat: MNIW) -> torch.Tensor:
    """Posterior mean coefficient matrix ``E[A] = (sym(T1)^{-1} T0)^T``,
    ``(n, m)``, of unbatched natural parameters."""
    return solve_spd(0.5 * (nat.T1 + nat.T1.T), nat.T0).T


class Predictive(NamedTuple):
    """Matrix-t predictive distribution at a basis vector ``phi (m,)``, or
    at the columns of ``phi (m, G)`` (then ``mean (n, G)`` and
    ``col_scale (G,)``)."""

    mean: torch.Tensor  # (n,)
    col_scale: torch.Tensor  # () phi^T V_post phi + 1
    row_scale: torch.Tensor  # (n, n)
    df: torch.Tensor  # ()


def factorize(nat: MNIW) -> MNIWFactor:
    """Factor ``sym(T1)`` of unbatched natural parameters once (the
    fields of :class:`MNIWFactor` without the batch axis): ``chol (m,
    m)``, ``white_T0 = chol^{-1} T0``, ``row_scale = T2 - white^T white``,
    ``df = T3``."""
    L = chol_spd(0.5 * (nat.T1 + nat.T1.T))
    white = torch.linalg.solve_triangular(L, nat.T0, upper=False)
    return MNIWFactor(L, white, nat.T2 - white.T @ white, nat.T3)


def factor_mean_at(factor: MNIWFactor, phi: torch.Tensor) -> torch.Tensor:
    """Posterior-mean prediction ``E[A] phi = white^T chol^{-1} phi`` from an
    unbatched factorization, at ``phi (m,)`` -> ``(n,)`` (or ``(m, G)`` ->
    ``(n, G)``)."""
    v = torch.linalg.solve_triangular(factor.chol, phi.reshape(phi.shape[0], -1), upper=False)
    mean = factor.white_T0.T @ v
    return mean[:, 0] if phi.dim() == 1 else mean


def factor_predictive(factor: MNIWFactor, phi: torch.Tensor) -> Predictive:
    """Matrix-t predictive at ``phi`` from an unbatched factorization, one
    triangular solve: ``v = chol^{-1} phi``, ``mean = white^T v``,
    ``col_scale = v^T v + 1``, ``row_scale / (df + 1 - n)``."""
    n = factor.row_scale.shape[-1]
    v = torch.linalg.solve_triangular(factor.chol, phi.reshape(phi.shape[0], -1),
                                      upper=False)
    mean = factor.white_T0.T @ v
    col_scale = (v * v).sum(0) + 1.0
    df = factor.df + 1.0 - n
    if phi.dim() == 1:
        mean, col_scale = mean[:, 0], col_scale[0]
    return Predictive(mean, col_scale, factor.row_scale / df, df)


def predictive(mean, col_cov, row_scale, df, phi) -> Predictive:
    """Matrix-t predictive from standard parameters: ``mean (n, m)`` (or
    ``(m,)`` for n = 1), ``col_cov (m, m)``, ``row_scale (n, n)`` (or a
    scalar), ``df``, at ``phi (m,)`` or ``(m, G)``."""
    mean = torch.atleast_2d(mean)
    row_scale = torch.atleast_2d(row_scale)
    df_pred = df + 1.0 - row_scale.shape[0]
    col_scale = (phi * (col_cov @ phi)).sum(0) + 1.0
    return Predictive(mean @ phi, col_scale, row_scale / df_pred, df_pred)


def sample_predictive(pred: Predictive, t: torch.Tensor) -> torch.Tensor:
    """Draw from the matrix-t predictive at one basis vector: ``mean +
    chol(row_scale) t sqrt(col_scale)`` with ``t (n,)`` iid Student-t draws
    of ``pred.df`` degrees of freedom, an input
    (:func:`predictive_t_draws` draws them from a generator)."""
    chol_row = chol_spd(torch.atleast_2d(pred.row_scale))
    return pred.mean + (chol_row @ t) * torch.sqrt(pred.col_scale)


def predictive_t_draws(generator: torch.Generator, pred: Predictive) -> torch.Tensor:
    """The ``(n,)`` Student-t draws that :func:`sample_predictive` takes,
    each from two uniforms of ``generator`` by the polar method
    (:func:`~bipk_tpu_torch.ops.gaussian.student_t`)."""
    row = torch.atleast_2d(pred.row_scale)
    u, v = (torch.rand((row.shape[0],), generator=generator, dtype=row.dtype,
                       device=row.device) for _ in range(2))
    return student_t(torch.as_tensor(pred.df, dtype=row.dtype, device=row.device), u, v)


def log_base_measure(nat: MNIW) -> torch.Tensor:
    """Log base measure (the marginal-likelihood normalizer) of unbatched
    natural parameters, from the Cholesky log-determinants of ``sym(T1)``
    and of ``sym(Psi)``, ``Psi = T2 - white^T white``."""
    n, m = nat.T2.shape[-1], nat.T1.shape[-1]
    L1 = chol_spd(0.5 * (nat.T1 + nat.T1.T))
    white = torch.linalg.solve_triangular(L1, nat.T0, upper=False)
    psi = nat.T2 - white.T @ white
    L_psi = chol_spd(0.5 * (psi + psi.T))
    nu = torch.as_tensor(nat.T3, dtype=nat.T1.dtype, device=nat.T1.device)
    return _log_base_measure(bla.logdet_from_chol(L1), bla.logdet_from_chol(L_psi), nu, m, n)


class ParameterDraws(NamedTuple):
    """The random numbers one :func:`sample_parameters` draw consumes."""

    chi2: torch.Tensor  # (n,) chi-square draws, degrees of freedom df - i
    lower: torch.Tensor  # (n, n) standard normals; the strict lower triangle is used
    coeff: torch.Tensor  # (n, m) standard normals of the matrix-normal draw


def sample_parameters(nat: MNIW, draws: ParameterDraws):
    """Draw ``(A (n, m), S (n, n))`` from the MNIW of unbatched natural
    parameters: ``S ~ IW(Psi, nu)``, ``A ~ MN(M, S, V)``.

    The inverse Wishart by the Bartlett decomposition on the precision
    side, as the JAX package: with ``R = chol(Psi)`` and the Bartlett
    factor ``T`` (``sqrt(chi2)`` on the diagonal, ``draws.lower``'s strict
    lower triangle below it), ``C = R^{-T} T`` is a Cholesky factor of
    ``W ~ Wishart(nu, Psi^{-1})`` and ``S = W^{-1}`` has the factor
    ``C^{-T}``. The draws are inputs (:func:`parameter_draws`)."""
    mean, col_cov, row_scale, _ = standard_from_natural(nat)
    n = row_scale.shape[0]
    eye = torch.eye(n, dtype=row_scale.dtype, device=row_scale.device)
    # L L^T = Psi^{-1}
    L = torch.linalg.solve_triangular(chol_spd(row_scale), eye, upper=False)
    bartlett = torch.tril(draws.lower, -1) + torch.diag(torch.sqrt(draws.chi2))
    C = L @ bartlett
    S_chol = torch.linalg.solve_triangular(C.T, eye, upper=True)
    A = mean + S_chol @ draws.coeff @ chol_spd(col_cov).T
    return A, S_chol @ S_chol.T


GAMMA_ATTEMPTS = 16  # Marsaglia-Tsang candidates per draw; each is accepted w.p. > 0.95


def chisquare(dof: torch.Tensor, z: torch.Tensor, u: torch.Tensor,
              u_boost: torch.Tensor) -> torch.Tensor:
    """Chi-square draws ``(n,)`` with ``dof (n,)`` degrees of freedom from
    ``GAMMA_ATTEMPTS`` rows of candidates: twice a Gamma(dof/2) draw by
    Marsaglia and Tsang's squeeze-free method (normals ``z (K, n)``,
    uniforms ``u (K, n)``; the first accepted row wins), boosted by
    ``u_boost (n,) ** (2/dof)`` where dof/2 < 1. Computed in float64.

    No host synchronisation: if every candidate of an entry is rejected
    (probability below 0.05**K), ``torch._assert_async`` raises, on the
    card as a device-side assertion."""
    out_dtype = dof.dtype
    dof, z, u, u_boost = (t.double() for t in (dof, z, u, u_boost))
    a = dof / 2.0
    shape = torch.where(a < 1.0, a + 1.0, a)
    d = shape - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    v = (1.0 + c * z) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v + d * torch.log(v.clamp(min=1e-300)))
    torch._assert_async(ok.any(0).all(), "chisquare: every candidate was rejected")
    first = torch.argmax(ok.to(torch.int8), 0, keepdim=True)
    gamma = (d * v).gather(0, first)[0]
    gamma = torch.where(a < 1.0, gamma * u_boost ** (1.0 / a), gamma)
    return (2.0 * gamma).to(out_dtype)


def draw_chisquare(generator: torch.Generator, dof: torch.Tensor) -> torch.Tensor:
    """Chi-square draws with ``dof (n,)`` degrees of freedom (a device
    tensor, never read on the host) from ``generator``: :func:`chisquare`
    of ``GAMMA_ATTEMPTS`` rows of candidates, on ``dof``'s device and
    dtype."""
    opts = dict(generator=generator, dtype=dof.dtype, device=dof.device)
    n = dof.shape[0]
    return chisquare(dof, torch.randn((GAMMA_ATTEMPTS, n), **opts),
                     1.0 - torch.rand((GAMMA_ATTEMPTS, n), **opts),
                     1.0 - torch.rand((n,), **opts))


def parameter_draws(generator: torch.Generator, df: torch.Tensor, n: int, m: int
                    ) -> ParameterDraws:
    """One :func:`sample_parameters` draw's random numbers from
    ``generator``, on ``df``'s device and dtype, for an MNIW with ``n``
    outputs, ``m`` basis functions and ``df`` (a 0-d tensor, the
    posterior's ``T3``) degrees of freedom: the chi-square draws have
    ``df - i``."""
    opts = dict(generator=generator, dtype=df.dtype, device=df.device)
    chi2 = draw_chisquare(generator, df - torch.arange(n, dtype=df.dtype, device=df.device))
    return ParameterDraws(chi2, torch.randn((n, n), **opts), torch.randn((n, m), **opts))


# ---------------------------------------------------------------------------
# Flat and packed layouts.
# ---------------------------------------------------------------------------


def to_flat_bl(nat: MNIW) -> MNIW:
    """Structured batch-last leaves -> flat rows ``(m*n, N)`` etc."""
    last = nat.T0.shape[-1]
    return MNIW(
        nat.T0.reshape(-1, last), nat.T1.reshape(-1, last),
        nat.T2.reshape(-1, last), nat.T3,
    )


def from_flat_bl(nat: MNIW, m: int, n: int) -> MNIW:
    """Flat rows -> structured batch-last leaves."""
    last = nat.T0.shape[-1]
    return MNIW(
        nat.T0.reshape(m, n, last), nat.T1.reshape(m, m, last),
        nat.T2.reshape(n, n, last), nat.T3,
    )


def _tri_pack_idx(m: int):
    """Flat indices (into an ``(m*m,)`` square) of the lower triangle in
    COLUMN-major order, plus the transposed entries' indices."""
    j, i = np.triu_indices(m)  # row <= col, row-major == lower col-major
    return i * m + j, j * m + i


def tri_col_offset(j: int, m: int) -> int:
    """Offset of column ``j``'s diagonal entry in the column-major packed
    lower triangle: ``sum_{c<j} (m - c)``."""
    return j * m - (j * (j - 1)) // 2


def _tri_unpack_idx(m: int):
    """For each entry of the flattened square, the triangular row that
    holds its value (column-major packing)."""
    i, j = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    hi, lo = np.maximum(i, j), np.minimum(i, j)
    return (lo * m - (lo * (lo - 1)) // 2 + hi - lo).reshape(-1)


@functools.lru_cache(maxsize=None)
def _index_tensors(m: int, device: torch.device):
    lower, upper = _tri_pack_idx(m)
    return tuple(
        torch.as_tensor(a, dtype=torch.long, device=device)
        for a in (lower, upper, _tri_unpack_idx(m))
    )


def sym_to_tri_rows(X: torch.Tensor, m: int) -> torch.Tensor:
    """``(m*m, ...)`` square rows -> ``(m(m+1)/2, ...)`` triangular rows
    of the symmetrized matrix ``0.5 (X + X^T)``."""
    lower, upper, _ = _index_tensors(m, X.device)
    return 0.5 * (X.index_select(0, lower) + X.index_select(0, upper))


def tri_to_sym_rows(Xt: torch.Tensor, m: int, dim: int = 0) -> torch.Tensor:
    """Triangular rows -> full ``(m*m, ...)`` square rows along ``dim``."""
    return Xt.index_select(dim, _index_tensors(m, Xt.device)[2])


def packed_rows(m: int, n: int) -> int:
    """Row count of the packed statistics layout."""
    return m * n + m * (m + 1) // 2 + n * (n + 1) // 2 + 1


def _offsets(m: int, n: int):
    o1 = m * n
    o2 = o1 + m * (m + 1) // 2
    return o1, o2, o2 + n * (n + 1) // 2


def pack_stats_bl(stats: MNIW) -> torch.Tensor:
    """Batch-last MNIW statistics (structured or flat) -> packed matrix."""
    if stats.T1.dim() != 2:
        stats = to_flat_bl(stats)
    m = int(round(stats.T1.shape[0] ** 0.5))
    n = int(round(stats.T2.shape[0] ** 0.5))
    return torch.cat(
        [
            stats.T0,
            sym_to_tri_rows(stats.T1, m),
            sym_to_tri_rows(stats.T2, n),
            stats.T3[None],
        ],
        0,
    )


def unpack_stats_bl(S: torch.Tensor, m: int, n: int) -> MNIW:
    """Packed matrix -> flat batch-last MNIW statistics (T1/T2 mirrored
    back to full squares)."""
    o1, o2, o3 = _offsets(m, n)
    return MNIW(
        S[:o1], tri_to_sym_rows(S[o1:o2], m), tri_to_sym_rows(S[o2:o3], n),
        S[o3],
    )


def unpack_reduced(red: torch.Tensor, m: int, n: int) -> MNIW:
    """Importance-weight-reduced packed columns ``(..., rows)`` ->
    structured MNIW with leaves ``(..., m, n)``, ``(..., m, m)``,
    ``(..., n, n)``, ``(...)``."""
    o1, o2, o3 = _offsets(m, n)
    lead = red.shape[:-1]
    d = red.dim() - 1
    return MNIW(
        red[..., :o1].reshape(*lead, m, n),
        tri_to_sym_rows(red[..., o1:o2], m, dim=d).reshape(*lead, m, m),
        tri_to_sym_rows(red[..., o2:o3], n, dim=d).reshape(*lead, n, n),
        red[..., o3],
    )


def suff_stat_bl(y: torch.Tensor, phi: torch.Tensor) -> MNIW:
    """Rank-1 statistics, structured batch-last: ``y (n, N)``, ``phi (m, N)``."""
    return MNIW(
        phi[:, None, :] * y[None, :, :],
        phi[:, None, :] * phi[None, :, :],
        y[:, None, :] * y[None, :, :],
        torch.ones(y.shape[-1], dtype=phi.dtype, device=phi.device),
    )


def suff_stat_flat_bl(y: torch.Tensor, phi: torch.Tensor) -> MNIW:
    """Rank-1 statistics in flat layout (row ``i*n + c`` of T0 is
    ``phi_i y_c``)."""
    return to_flat_bl(suff_stat_bl(y, phi))


# ---------------------------------------------------------------------------
# Factorization and the matrix-t predictive.
# ---------------------------------------------------------------------------


def _gram_bl(W: torch.Tensor) -> torch.Tensor:
    """``(m, n, N) -> (n, n, N)`` Gram matrix ``W^T W`` over axis 0."""
    return (W[:, :, None, :] * W[:, None, :, :]).sum(0)


def kernels_take(name: str, t: torch.Tensor, m: int, n: int, plain: bool) -> bool:
    """Whether entry point ``name`` launches its kernel: on a CUDA tensor,
    unless ``plain`` (the JAX package's ``use_pallas=False``). A CUDA
    tensor the kernels cannot take (not float32, m > 48 or n > 2) raises,
    as the packed wrappers do; only ``plain=True`` asks for the plain
    version on the card. CPU tensors take the plain version."""
    from bipk_tpu_torch.ops import cuda_kernels as ck

    if plain or t.device.type != "cuda":
        return False
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernels take float32 on the card, got {t.dtype}; "
                        "pass plain=True for the plain version")
    if not (1 <= m <= ck.MAX_M and 1 <= n <= ck.MAX_N):
        raise ValueError(f"{name}: the kernels need 1 <= m <= {ck.MAX_M}, 1 <= n <= "
                         f"{ck.MAX_N} on the card; got m={m}, n={n}; pass plain=True "
                         "for the plain version")
    return True


def _c(*tensors):
    return tuple(t.contiguous() for t in tensors)


def _factorize_bl_plain(nat: MNIW, jitter: float) -> MNIWFactor:
    T1s = 0.5 * (nat.T1 + nat.T1.transpose(0, 1))
    if jitter:
        m = T1s.shape[0]
        trace = torch.diagonal(T1s, 0, 0, 1).sum(-1) / m
        eye = torch.eye(m, dtype=T1s.dtype, device=T1s.device)[:, :, None]
        T1s = T1s + (jitter * trace) * eye
    L = bla.chol_lower_bl(T1s)
    white = bla.solve_lower_bl(L, nat.T0)
    return MNIWFactor(L, white, nat.T2 - _gram_bl(white), nat.T3)


def factorize_bl(nat: MNIW, jitter: float | None = None, plain: bool = False) -> MNIWFactor:
    """Factor batch-last ``nat`` (structured leaves): symmetrize ``T1``,
    add the relative jitter ``jitter * trace/m`` to its diagonal,
    Cholesky, whiten ``T0`` and form the Schur complement ``T2 - white^T
    white``.

    On CUDA leaves this launches ``cuda_kernels.factorize_blocks``
    (float32, m <= 48, n <= 2; other CUDA leaves raise); CPU leaves, or
    ``plain=True``, take the plain PyTorch version."""
    if jitter is None:
        jitter = _default_jitter(nat.T1.dtype)
    m, n = nat.T0.shape[0], nat.T0.shape[1]
    if kernels_take("factorize_bl", nat.T1, m, n, plain):
        from bipk_tpu_torch.ops import cuda_kernels as ck

        chol, white, row = ck.factorize_blocks(*_c(nat.T0, nat.T1, nat.T2), jitter)
        return MNIWFactor(chol, white, row, nat.T3)
    return _factorize_bl_plain(nat, jitter)


def _scaled_df(stats: MNIW, prior: MNIW | None, lam: float):
    return stats.T3 * lam + (prior.T3 if prior is not None else 0.0)


def _factorize_scaled_bl_plain(stats: MNIW, prior: MNIW | None, lam: float,
                               jitter: float) -> MNIWFactor:
    df = _scaled_df(stats, prior, lam)
    nat = MNIW(stats.T0 * lam, stats.T1 * lam, stats.T2 * lam, df)
    if prior is not None:
        nat = MNIW(
            nat.T0 + prior.T0[..., None], nat.T1 + prior.T1[..., None],
            nat.T2 + prior.T2[..., None], df,
        )
    return _factorize_bl_plain(nat, jitter)


def _prior_blocks(prior: MNIW | None):
    return None if prior is None else _c(prior.T0, prior.T1, prior.T2)


def factorize_scaled_bl(
    stats: MNIW, prior: MNIW | None = None, lam: float = 1.0,
    jitter: float | None = None, plain: bool = False,
) -> MNIWFactor:
    """Factor ``prior + lam * stats`` (structured leaves); ``prior`` is
    UNbatched. Dispatches as :func:`factorize_bl` does, the prior and
    ``lam`` folded into the kernel."""
    if jitter is None:
        jitter = _default_jitter(stats.T1.dtype)
    m, n = stats.T0.shape[0], stats.T0.shape[1]
    if kernels_take("factorize_scaled_bl", stats.T1, m, n, plain):
        from bipk_tpu_torch.ops import cuda_kernels as ck

        chol, white, row = ck.factorize_blocks(
            *_c(stats.T0, stats.T1, stats.T2), jitter, lam, _prior_blocks(prior))
        return MNIWFactor(chol, white, row, _scaled_df(stats, prior, lam))
    return _factorize_scaled_bl_plain(stats, prior, lam, jitter)


def _logdet_psi(psi: torch.Tensor) -> torch.Tensor:
    n = psi.shape[0]
    if n == 1:
        return torch.log(psi[0, 0])
    if n == 2:
        off = 0.5 * (psi[0, 1] + psi[1, 0])
        return torch.log(psi[0, 0] * psi[1, 1] - off * off)
    sym = 0.5 * (psi + psi.transpose(0, 1))
    return bla.logdet_from_chol_bl(bla.chol_lower_bl(sym))


def _project_mean_col(chol, white, phi):
    """``v = chol^{-1} phi``: ``(white^T v (n, N), |v|^2 + 1 (N,))``. A
    strided ``white`` (a view of an augmented factor) is summed in the
    order of a contiguous one, so views and copies agree bit for bit."""
    v = bla.solve_lower_bl(chol, phi)
    return (white.contiguous() * v[:, None, :]).sum(0), (v * v).sum(0) + 1.0


def project_bl(f: MNIWFactor, phi: torch.Tensor) -> ProjectedFactor:
    """Project a factored MNIW at ``phi (m, N)``: ``mean = white^T L^{-1}
    phi``, ``col = |L^{-1} phi|^2 + 1``, ``Psi``, and the two
    log-determinants (plain PyTorch)."""
    mean, col = _project_mean_col(f.chol, f.white_T0, phi)
    return ProjectedFactor(
        mean, col, f.row_scale, bla.logdet_from_chol_bl(f.chol),
        _logdet_psi(f.row_scale), f.df,
    )


def _factorize_project_bl_plain(stats: MNIW, phi, prior, lam, jitter) -> ProjectedFactor:
    if stats.T1.dim() == 2:
        m = phi.shape[0]
        stats = from_flat_bl(stats, m, stats.T0.shape[0] // m)
    return project_bl(_factorize_scaled_bl_plain(stats, prior, lam, jitter), phi)


def factorize_project_bl(
    stats: MNIW, phi: torch.Tensor, prior: MNIW | None = None,
    lam: float = 1.0, jitter: float | None = None, plain: bool = False,
) -> ProjectedFactor:
    """Factor ``prior + lam * stats`` and project at ``phi (m, N)``
    (:func:`project_bl`); the factor is never formed in memory by the
    kernel. ``stats`` structured or flat (``(m*n, N)`` etc.; ``m`` is
    ``phi``'s). Dispatches to ``cuda_kernels.factorize_project_blocks``
    as :func:`factorize_bl` does."""
    if jitter is None:
        jitter = _default_jitter(stats.T1.dtype)
    m = phi.shape[0]
    n = stats.T0.shape[0] // m if stats.T1.dim() == 2 else stats.T0.shape[1]
    if kernels_take("factorize_project_bl", stats.T1, m, n, plain):
        from bipk_tpu_torch.ops import cuda_kernels as ck

        out = ck.factorize_project_blocks(
            *_c(stats.T0, stats.T1, stats.T2, phi), jitter, lam, _prior_blocks(prior),
            m=m, n=n)
        return ProjectedFactor(*out, _scaled_df(stats, prior, lam))
    return _factorize_project_bl_plain(stats, phi, prior, lam, jitter)


def _project_factor(name: str, factor: MNIWFactor, phi, plain: bool):
    """``(mean, col)`` of :func:`project_bl` from a given factor: on the
    card the projection kernel, which reads ``chol`` and ``white`` in
    place (strided views, e.g. of an augmented factor, included), as
    :func:`kernels_take` decides; else the plain version."""
    m, n = factor.white_T0.shape[0], factor.white_T0.shape[1]
    if kernels_take(name, factor.chol, m, n, plain):
        from bipk_tpu_torch.ops import cuda_kernels as ck

        return ck.project_blocks(factor.chol, factor.white_T0, phi.contiguous())
    return _project_mean_col(factor.chol, factor.white_T0, phi)


def factor_mean_at_bl(factor: MNIWFactor, phi: torch.Tensor, plain: bool = False):
    """Posterior-mean prediction from a factor, ``phi (m, N) -> (n, N)``:
    ``white^T chol^{-1} phi``, through the projection kernel on CUDA
    tensors (:func:`_project_factor`)."""
    return _project_factor("factor_mean_at_bl", factor, phi, plain)[0]


def sample_predictive_bl(
    factor: MNIWFactor, phi: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
    plain: bool = False,
) -> torch.Tensor:
    """Matrix-t predictive draw from a factor at ``phi (m, N)``: the
    projection of :func:`factor_mean_at_bl` (one kernel for the mean and
    the column scale), then :func:`sample_projected_bl`'s draw with the
    uniforms ``u, v (n, N)`` and ``df = factor.df``."""
    mean, col = _project_factor("sample_predictive_bl", factor, phi, plain)
    fp = ProjectedFactor(mean, col, factor.row_scale, None, None, factor.df)
    return sample_projected_bl(fp, u, v)


def sample_projected_bl(
    fp: ProjectedFactor, u: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Matrix-t draw ``y = mean + chol(Psi/df_pred) t sqrt(col)`` with
    ``t`` polar Student-t from the uniforms ``u, v (n, N)`` and
    ``df_pred = df + 1 - n``."""
    n = fp.row_scale.shape[0]
    df_pred = fp.df + (1.0 - n)
    chol_row = bla.chol_lower_bl(fp.row_scale / df_pred)
    t = student_t(df_pred, u, v)
    scaled = (chol_row * t[None, :, :]).sum(1)
    return fp.mean + scaled * torch.sqrt(fp.col_scale)


# ---------------------------------------------------------------------------
# Packed entry points: the plain versions of the CUDA kernels.
# ---------------------------------------------------------------------------


# the widest m of the factor-emitting projection and the factor-reusing
# draw (the JAX package's supported_factor: its tiled layout, m <= 24)
FACTOR_MAX_M = 24


def lw_rows(m: int, n: int) -> int:
    """Row count of the packed factor ``LW``."""
    return m * (m + 1) // 2 + m * n


@functools.lru_cache(maxsize=None)
def _row_major_tril(m: int, device: torch.device) -> torch.Tensor:
    """Flat indices (into an ``(m*m,)`` square) of the lower triangle in
    ROW-major order: entry ``i(i+1)/2 + k`` is ``(i, k)``."""
    i, k = np.tril_indices(m)
    return torch.as_tensor(i * m + k, dtype=torch.long, device=device)


def factor_to_lw(f: MNIWFactor) -> torch.Tensor:
    """``LW (m(m+1)/2 + m*n, N)``: rows ``[tril(chol) row-major | white_T0
    (row i*n + c)]``, the layout of the JAX ``_packed_fp_emit_kernel``."""
    m, n, N = f.white_T0.shape
    tril = f.chol.reshape(m * m, N).index_select(0, _row_major_tril(m, f.chol.device))
    return torch.cat([tril, f.white_T0.reshape(m * n, N)], 0)


def lw_to_factor(LW: torch.Tensor, m: int, n: int):
    """``LW`` -> ``(chol (m, m, N) lower, white_T0 (m, n, N))``."""
    N = LW.shape[-1]
    tri = m * (m + 1) // 2
    chol = torch.zeros((m * m, N), dtype=LW.dtype, device=LW.device).index_copy(
        0, _row_major_tril(m, LW.device), LW[:tri])
    return chol.reshape(m, m, N), LW[tri:].reshape(m, n, N)


def factorize_project_packed_bl(
    S: torch.Tensor, phi: torch.Tensor, prior: MNIW | None = None,
    lam: float = 1.0, m: int = 0, n: int = 0, jitter: float | None = None,
    emit_factor: bool = False,
):
    """:func:`factorize_project_bl` over the packed statistics ``S (rows,
    N)``. With ``emit_factor`` returns ``(ProjectedFactor, LW)``, ``LW``
    the factor for :func:`draw_update_factor_gather_packed_bl`
    (:func:`factor_to_lw`), or ``(fp, None)`` where ``m >
    FACTOR_MAX_M``, as the JAX function does where its factor pair is
    unavailable."""
    if jitter is None:
        jitter = _default_jitter(S.dtype)
    f = _factorize_scaled_bl_plain(
        from_flat_bl(unpack_stats_bl(S, m, n), m, n), prior, lam, jitter)
    fp = project_bl(f, phi)
    if not emit_factor:
        return fp
    return fp, (factor_to_lw(f) if m <= FACTOR_MAX_M else None)


def _update_packed(stats: MNIW, y, phi, lam):
    """``lam * stats + suff(y, phi)`` packed (flat ``stats``)."""
    suff = suff_stat_flat_bl(y, phi)
    return pack_stats_bl(MNIW(*(s * lam + d for s, d in zip(stats, suff))))


def draw_update_packed_bl(
    u: torch.Tensor, v: torch.Tensor, S: torch.Tensor, phi: torch.Tensor,
    prior: MNIW | None = None, lam: float = 1.0, m: int = 0, n: int = 0,
    jitter: float | None = None,
):
    """Matrix-t predictive draw + rank-1 statistics update over the packed
    layout: returns ``(S_new, y, logdet_T1, logdet_Psi)`` with
    ``S_new = lam * S + suff(y, phi)``. ``u, v (n, N)`` are the raw
    uniforms of the polar Student-t draw."""
    if jitter is None:
        jitter = _default_jitter(S.dtype)
    stats = unpack_stats_bl(S, m, n)
    fp = _factorize_project_bl_plain(from_flat_bl(stats, m, n), phi, prior, lam, jitter)
    y = sample_projected_bl(fp, u, v)
    return _update_packed(stats, y, phi, lam), y, fp.logdet_T1, fp.logdet_Psi


def draw_update_factor_gather_packed_bl(
    u: torch.Tensor, v: torch.Tensor, S: torch.Tensor, LW: torch.Tensor,
    ancestors: torch.Tensor, phi: torch.Tensor, prior: MNIW | None = None,
    lam: float = 1.0, m: int = 0, n: int = 0,
):
    """:func:`draw_update_packed_bl` on ``S[:, ancestors]`` that reads the
    factor of ``prior + lam * S`` from ``LW[:, ancestors]``
    (:func:`factorize_project_packed_bl` with ``emit_factor``, the same
    ``prior`` and ``lam``) instead of factoring again: ``Psi = P2 + lam T2
    - white^T white``, the projection at ``phi`` and the draw. The result
    is the refactoring one's wherever ``LW`` is the factor of those
    statistics."""
    stats = unpack_stats_bl(S.index_select(1, ancestors), m, n)
    chol, white = lw_to_factor(LW.index_select(1, ancestors), m, n)
    T2 = stats.T2.reshape(n, n, -1) * lam
    df = stats.T3 * lam
    if prior is not None:
        T2, df = T2 + prior.T2[..., None], df + prior.T3
    fp = project_bl(MNIWFactor(chol, white, T2 - _gram_bl(white), df), phi)
    y = sample_projected_bl(fp, u, v)
    return _update_packed(stats, y, phi, lam), y, fp.logdet_T1, fp.logdet_Psi


def draw_update_gather_packed_bl(
    u: torch.Tensor, v: torch.Tensor, S: torch.Tensor,
    ancestors: torch.Tensor, phi: torch.Tensor, prior: MNIW | None = None,
    lam: float = 1.0, m: int = 0, n: int = 0, jitter: float | None = None,
    factor: torch.Tensor | None = None, dedup: bool = False,
    plain: bool = False,
):
    """Resampling gather + matrix-t draw + rank-1 update: the result is
    ``draw_update_packed_bl(u, v, S[:, ancestors], ...)``; ``u, v, phi``
    and the outputs have ``len(ancestors)`` columns, ``ancestors`` is
    sorted int32.

    Runs one of three kernel wrappers of :mod:`~bipk_tpu_torch.ops.
    cuda_kernels` (their plain versions with ``plain=True``), as the JAX
    dispatch (``bipk_tpu/ops/mniw.py:900-1100``) picks its kernel without
    its lane windows and ``lax.cond`` tiers: the factor-reusing draw when
    ``factor`` (the look-ahead's ``LW`` of the same statistics, prior and
    ``lam``) is given and ``m <= FACTOR_MAX_M``; else the dedup gather
    when ``dedup`` and ``m <= 24``; else the gather/draw kernel. With both,
    the factor wins, as in JAX. ``prior.T3`` is read as a host number:
    pass a Python float, not a device scalar, or the call synchronises.
    """
    from bipk_tpu_torch.ops import cuda_kernels as ck

    if jitter is None:
        jitter = _default_jitter(S.dtype)
    blocks = None if prior is None else tuple(prior[:3])
    p3 = 0.0 if prior is None else float(prior.T3)
    if factor is not None and m <= FACTOR_MAX_M:
        fn, args = ck.draw_update_factor_gather_packed_blocks, (S, factor)
    elif dedup and m <= ck.DEDUP_MAX_M:
        fn, args = ck.draw_update_dedup_gather_packed_blocks, (S,)
    else:
        fn, args = ck.draw_update_gather_packed_blocks, (S,)
    if plain:
        fn = ck.PLAIN[fn]
    return fn(*args, ancestors, phi, u, v, jitter, lam, blocks, p3, m=m, n=n)


# ---------------------------------------------------------------------------
# Log base measures (the cSMC ancestor weights).
# ---------------------------------------------------------------------------


def suff_stat(y: torch.Tensor, phi: torch.Tensor) -> MNIW:
    """Rank-1 statistics of ONE datum ``y (n,)`` (or a scalar), ``phi
    (m,)``: ``(phi y^T, phi phi^T, y y^T, 1)``."""
    y = torch.atleast_1d(y)
    return MNIW(
        torch.outer(phi, y), torch.outer(phi, phi), torch.outer(y, y),
        torch.ones((), dtype=phi.dtype, device=phi.device),
    )


def pack_suff_col(y: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Packed rank-1 statistics of ONE datum: ``y (n,)``, ``phi (m,)`` ->
    the ``(rows,)`` column of :func:`packed_rows` rows."""
    return pack_stats_bl(suff_stat_flat_bl(y[:, None], phi[:, None]))[:, 0]


def multigammaln(a: torch.Tensor, n: int) -> torch.Tensor:
    """Multivariate log-gamma ``log Gamma_n(a)`` from ``torch.lgamma``:
    ``n(n-1)/4 log(pi) + sum_{j<n} lgamma(a - j/2)``. Written out rather
    than ``torch.special.multigammaln``, which in some releases checks its
    domain with a host-side ``.all()`` (a device synchronisation)."""
    out = torch.lgamma(a)
    for j in range(1, n):
        out = out + torch.lgamma(a - 0.5 * j)
    return out + (n * (n - 1) / 4.0) * math.log(math.pi)


def _log_base_measure(logdet_T1, logdet_Psi, nu, m: int, n: int):
    """The MNIW log base measure from its two log-determinants."""
    out = 0.5 * n * logdet_T1 - (0.5 * n * m) * math.log(2.0 * math.pi)
    out = out - (0.5 * n * math.log(2.0)) * nu
    out = out - multigammaln(0.5 * nu, n)
    return out + 0.5 * nu * logdet_Psi


def _base_measure_logdets_plain(nat: MNIW, jitter: float):
    """``(logdet sym(T1), logdet sym(Psi))`` of structured ``nat``, the
    second as :func:`packed_logdets_bl` takes it."""
    f = _factorize_bl_plain(nat, jitter)
    return bla.logdet_from_chol_bl(f.chol), _logdet_psi(f.row_scale)


def log_base_measure_bl(
    nat: MNIW, m: int | None = None, n: int | None = None,
    jitter: float | None = None, plain: bool = False,
) -> torch.Tensor:
    """Batch-last MNIW log base measure ``(N,)`` of ``nat`` (structured
    leaves, or flat ones with ``m``/``n``): relative jitter on ``sym(T1)``,
    Cholesky, Schur complement ``Psi``, and ``logdet Psi``.

    On CUDA leaves the two log-determinants come from
    ``cuda_kernels.log_base_measure_logdets`` (float32, m <= 48, n <= 2;
    other CUDA leaves raise); CPU leaves, or ``plain=True``, take the
    plain PyTorch version."""
    if jitter is None:
        jitter = _default_jitter(nat.T1.dtype)
    if nat.T1.dim() == 3:
        m, n = nat.T0.shape[0], nat.T0.shape[1]
    if kernels_take("log_base_measure_bl", nat.T1, m, n, plain):
        from bipk_tpu_torch.ops import cuda_kernels as ck

        ld1, ldp = ck.log_base_measure_logdets(
            *_c(nat.T0, nat.T1, nat.T2), jitter, m=m, n=n)
    else:
        flat = nat.T1.dim() == 2
        ld1, ldp = _base_measure_logdets_plain(from_flat_bl(nat, m, n) if flat else nat, jitter)
    return _log_base_measure(ld1, ldp, nat.T3, m, n)


def log_base_measure_from_factor_bl(factor: MNIWFactor) -> torch.Tensor:
    """The log base measure from an existing factorization (``factor =
    factorize_scaled_bl(stats, prior)`` gives that of ``prior + stats``):
    the log-determinants off the factor's diagonal and Schur complement."""
    m, n = factor.white_T0.shape[0], factor.white_T0.shape[1]
    return _log_base_measure(bla.logdet_from_chol_bl(factor.chol),
                             _logdet_psi(factor.row_scale), factor.df, m, n)


def log_base_measure_from_projected_bl(fp: ProjectedFactor, m: int) -> torch.Tensor:
    """The log base measure from factorize/project outputs (the MNIW that
    was factored, with its ``df``)."""
    return _log_base_measure(
        fp.logdet_T1, fp.logdet_Psi, fp.df, m, fp.row_scale.shape[0]
    )


def packed_logdets_bl(
    S: torch.Tensor, prior: MNIW | None, m: int, n: int,
    jitter: float | None = None,
):
    """``(logdet_T1, logdet_Psi)`` of ``prior + S`` per particle, over the
    packed layout (``prior`` unbatched; its ``T3`` is not read)."""
    stats = from_flat_bl(unpack_stats_bl(S, m, n), m, n)
    if prior is not None:
        stats = MNIW(
            stats.T0 + prior.T0[..., None], stats.T1 + prior.T1[..., None],
            stats.T2 + prior.T2[..., None], stats.T3,
        )
    if jitter is None:
        jitter = _default_jitter(S.dtype)
    f = _factorize_bl_plain(stats, jitter)
    return bla.logdet_from_chol_bl(f.chol), _logdet_psi(f.row_scale)


def log_base_measure_packed_bl(
    S: torch.Tensor, prior_eff: MNIW | None, m: int, n: int,
    jitter: float | None = None, logdets=None,
) -> torch.Tensor:
    """:func:`log_base_measure_bl` of ``prior_eff + S`` over the packed
    layout, ``(N,)``.

    ``prior_eff`` is a small unbatched offset (``prior + ref_future`` in
    the cSMC ancestor weights) folded into the log-determinant kernel, so
    the per-particle sum is never materialized. ``logdets(S, jitter,
    (P0, P1, P2), m, n)`` computes the two log-determinants; the default
    is the CUDA kernel wrapper ``cuda_kernels.
    log_base_measure_packed_logdets`` (its plain version on CPU tensors).
    """
    if jitter is None:
        jitter = _default_jitter(S.dtype)
    if logdets is None:
        from bipk_tpu_torch.ops import cuda_kernels

        logdets = cuda_kernels.log_base_measure_packed_logdets
    blocks = None if prior_eff is None else tuple(prior_eff[:3])
    nu = S[-1] if prior_eff is None else S[-1] + prior_eff.T3
    ld1, ldp = logdets(S, jitter, blocks, m, n)
    return _log_base_measure(ld1, ldp, nu, m, n)


def to_batch_last(nat: MNIW) -> MNIW:
    """``(N, ...)`` leaves -> the batch-last layout (``T3`` as it is)."""
    return MNIW(nat.T0.movedim(0, -1), nat.T1.movedim(0, -1), nat.T2.movedim(0, -1), nat.T3)


def from_batch_last(nat: MNIW) -> MNIW:
    """Batch-last leaves -> ``(N, ...)`` (``T3`` as it is)."""
    return MNIW(nat.T0.movedim(-1, 0), nat.T1.movedim(-1, 0), nat.T2.movedim(-1, 0), nat.T3)
