"""The matrix-normal-inverse-Wishart (MNIW) algebra of the per-particle
statistics, batch first, from its equations.

Natural parameters (or additive sufficient statistics) ``T0 (m, n)``,
``T1 (m, m)``, ``T2 (n, n)``, ``T3`` per particle. The program carries
them packed, one column per particle, rows ``[T0 (entry (i, c) at row i n
+ c) | the lower triangle of T1, column by column | the lower triangle of
T2, column by column | T3]``; :func:`unpack` and :func:`pack` read and
write that layout to judge the program's statistics.

Every matrix product goes through :meth:`Arith.mm`, so that the control
(float32 with TF32 operands) differs from the reference (float64) in the
products only, as a TF32 matmul would.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` rounded to TF32's 10-bit mantissa (nearest, ties to
    even), as the tensor cores read a TF32 operand."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class Arith:
    """The reference's number format: ``float64`` (the reference) or
    ``float32`` with TF32 operands in every product (``tf32=True``, the
    control)."""

    def __init__(self, dtype=torch.float64, tf32: bool = False):
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 operands are float32")
        self.dtype = dtype
        self.tf32 = tf32

    def __call__(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return torch.matmul(a, b)


TF32 = Arith(torch.float32, tf32=True)  # the control's format


class Stats(NamedTuple):
    T0: torch.Tensor  # (N, m, n)
    T1: torch.Tensor  # (N, m, m)
    T2: torch.Tensor  # (N, n, n)
    T3: torch.Tensor  # (N,)


def packed_rows(m: int, n: int) -> int:
    return m * n + m * (m + 1) // 2 + n * (n + 1) // 2 + 1


def _tril_colmajor(k: int):
    """(row, col) of the lower triangle of a ``k x k`` matrix, column by
    column."""
    rows, cols = [], []
    for j in range(k):
        for i in range(j, k):
            rows.append(i)
            cols.append(j)
    return np.array(rows), np.array(cols)


def unpack(S: torch.Tensor, m: int, n: int) -> Stats:
    """Packed ``(rows, N)`` columns -> batch-first :class:`Stats`, the
    symmetric blocks mirrored."""
    N = S.shape[1]
    S = S.T
    o1 = m * n
    o2 = o1 + m * (m + 1) // 2
    o3 = o2 + n * (n + 1) // 2
    T0 = S[:, :o1].reshape(N, m, n)

    def sym(block, k):
        r, c = _tril_colmajor(k)
        out = block.new_zeros((N, k, k))
        out[:, r, c] = block
        out[:, c, r] = block
        return out

    return Stats(T0, sym(S[:, o1:o2], m), sym(S[:, o2:o3], n), S[:, o3])


def pack(st: Stats) -> torch.Tensor:
    """Batch-first :class:`Stats` -> packed ``(rows, N)`` (the lower
    triangles of the symmetric parts of ``T1``, ``T2``)."""
    N, m, n = st.T0.shape
    rm, cm = _tril_colmajor(m)
    rn, cn = _tril_colmajor(n)
    T1 = 0.5 * (st.T1 + st.T1.transpose(1, 2))
    T2 = 0.5 * (st.T2 + st.T2.transpose(1, 2))
    return torch.cat([st.T0.reshape(N, m * n), T1[:, rm, cm], T2[:, rn, cn],
                      st.T3[:, None]], 1).T


def suff(ar: Arith, y: torch.Tensor, phi: torch.Tensor) -> Stats:
    """Rank-1 statistics of data ``y (N, n)`` at features ``phi (N, m)``."""
    return Stats(ar.mm(phi[:, :, None], y[:, None, :]), ar.mm(phi[:, :, None], phi[:, None, :]),
                 ar.mm(y[:, :, None], y[:, None, :]), torch.ones_like(y[:, 0]))


def packed_suff(y: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """The packed columns of ``suff(y, phi)`` (``y (N, n)``, ``phi (N,
    m)``) straight from the products of their entries."""
    N, m = phi.shape
    n = y.shape[1]
    rm, cm = _tril_colmajor(m)
    rn, cn = _tril_colmajor(n)
    return torch.cat([(phi[:, :, None] * y[:, None, :]).reshape(N, m * n),
                      phi[:, rm] * phi[:, cm], y[:, rn] * y[:, cn],
                      torch.ones_like(y[:, :1])], 1).T


class Prior(NamedTuple):
    """An unbatched MNIW in natural form."""

    T0: torch.Tensor  # (m, n)
    T1: torch.Tensor
    T2: torch.Tensor
    T3: float


def prior_from_standard(mean, col_cov, row_scale, df) -> Prior:
    """Natural parameters of the prior (float64 numpy): ``T1 = V^{-1}``,
    ``T0 = V^{-1} M^T``, ``T2 = M T0 + Psi``, ``T3 = df``."""
    mean = np.atleast_2d(np.asarray(mean, np.float64))
    col_cov = np.asarray(col_cov, np.float64)
    T1 = np.linalg.inv(col_cov)
    T0 = T1 @ mean.T
    T2 = mean @ T0 + np.atleast_2d(np.asarray(row_scale, np.float64))
    return Prior(torch.as_tensor(T0), torch.as_tensor(T1), torch.as_tensor(T2), float(df))


class Factor(NamedTuple):
    L: torch.Tensor  # (N, m, m) lower Cholesky factor of the column precision
    white: torch.Tensor  # (N, m, n) = L^{-1} T0
    psi: torch.Tensor  # (N, n, n) = T2 - white^T white
    df: torch.Tensor  # (N,)


def factor(ar: Arith, st: Stats, prior: Prior, lam: float, jitter: float,
           extra: Prior | None = None) -> Factor:
    """Factor ``prior (+ extra) + lam * st`` per particle: the symmetric
    ``T1`` with ``jitter * trace / m`` on its diagonal, its Cholesky
    factor, ``T0`` whitened and the Schur complement."""
    dev = st.T0.device
    P0, P1, P2 = (ar(p).to(dev) for p in prior[:3])
    p3 = prior.T3
    if extra is not None:
        P0, P1, P2 = P0 + ar(extra.T0).to(dev), P1 + ar(extra.T1).to(dev), P2 + ar(extra.T2).to(dev)
        p3 = p3 + extra.T3
    T1 = P1 + lam * st.T1
    T1 = 0.5 * (T1 + T1.transpose(1, 2))
    m = T1.shape[-1]
    if jitter:
        tr = torch.diagonal(T1, 0, 1, 2).sum(-1) / m
        T1 = T1 + (jitter * tr)[:, None, None] * torch.eye(m, dtype=T1.dtype, device=dev)
    L = torch.linalg.cholesky(T1)
    white = torch.linalg.solve_triangular(L, P0 + lam * st.T0, upper=False)
    psi = P2 + lam * st.T2 - ar.mm(white.transpose(1, 2), white)
    df = p3 + lam * st.T3
    return Factor(L, white, psi, df)


def project(ar: Arith, f: Factor, phi: torch.Tensor):
    """``(mean (N, n), col (N,))``: the posterior mean ``white^T L^{-1}
    phi`` and the column scale ``|L^{-1} phi|^2 + 1`` at ``phi (N, m)``."""
    v = torch.linalg.solve_triangular(f.L, phi[:, :, None], upper=False)
    mean = ar.mm(f.white.transpose(1, 2), v)[:, :, 0]
    col = ar.mm(v.transpose(1, 2), v)[:, 0, 0] + 1.0
    return mean, col


def student_t(df, u, v):
    """The polar Student-t draw from two uniforms: ``sqrt(df ((1 -
    u)^{-2/df} - 1)) cos(2 pi v)``."""
    r = torch.sqrt(df * torch.expm1(-(2.0 / df) * torch.log(1.0 - u)))
    return r * torch.cos((2.0 * math.pi) * v)


def draw(ar: Arith, f: Factor, phi, u, v):
    """The matrix-t predictive draw at ``phi (N, m)`` from the uniforms
    ``u, v (N, n)``: ``mean + chol(psi / df') t sqrt(col)``, ``df' = df + 1
    - n``, ``t`` Student-t with ``df'`` degrees of freedom."""
    mean, col = project(ar, f, phi)
    n = mean.shape[1]
    dfp = f.df + (1.0 - n)
    chol_row = torch.linalg.cholesky(f.psi / dfp[:, None, None])
    t = student_t(dfp[:, None], u, v)
    return mean + ar.mm(chol_row, t[:, :, None])[:, :, 0] * torch.sqrt(col)[:, None]


def logdets(f: Factor):
    """``(log det T1, log det psi)`` of a factor."""
    ld1 = 2.0 * torch.log(torch.diagonal(f.L, 0, 1, 2)).sum(-1)
    return ld1, torch.logdet(f.psi)


def log_base_measure(f: Factor, nu=None):
    """The MNIW log base measure (the marginal likelihood's normalizer) of
    a factored MNIW, ``nu`` its degrees of freedom (default ``f.df``)."""
    m, n = f.white.shape[1], f.white.shape[2]
    nu = f.df if nu is None else nu
    ld1, ldp = logdets(f)
    mgl = torch.lgamma(0.5 * nu)
    for j in range(1, n):
        mgl = mgl + torch.lgamma(0.5 * nu - 0.5 * j)
    mgl = mgl + n * (n - 1) / 4.0 * math.log(math.pi)
    return (0.5 * n * ld1 - 0.5 * n * m * math.log(2.0 * math.pi)
            - 0.5 * n * math.log(2.0) * nu - mgl + 0.5 * nu * ldp)
