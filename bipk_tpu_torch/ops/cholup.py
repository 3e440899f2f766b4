"""Rank-1 Cholesky maintenance for the rank-1 factor-carry cSMC (port of
``bipk_tpu/ops/cholup.py``).

The cSMC runs at forgetting factor 1, so each particle's ``prior + stats``
changes only by rank-1 data updates ``+ z z^T`` (``z = [phi; y]``) and the
reference's future statistics only by rank-1 decrements. The rank-1 sweep
carries the **augmented** lower Cholesky factor of

    M = [[T1, T0], [T0^T, T2]]   (p = m + n)

whose blocks are ``[[L, 0], [W^T, C]]`` with ``L = chol(T1)``, ``W =
L^{-1} T0`` and ``C = chol(Psi)``, ``Psi = T2 - W^T W``: the pieces of an
:class:`~bipk_tpu_torch.ops.mniw.MNIWFactor`, so views of the factor feed
the projection kernel (``cuda_kernels.project_blocks``) in place, and the
log-determinants come off its diagonal.

Plain PyTorch, as the JAX package's is plain XLA: batch-last ``(p, p,
N)``. The JAX functions unroll every ``(i, j)`` entry; here the entries
below the diagonal of one column, which depend only on their own row and
the column's rotation ``(c, s)``, are one tensor op per term, with the
same arithmetic per element (eight launches per column on the card). A
caller with several factors of one order updates them in one call,
concatenated along the particle axis (the rank-1 cSMC does).
"""

from __future__ import annotations

import math

import torch

from bipk_tpu_torch.ops import batched_linalg as bla
from bipk_tpu_torch.ops import mniw


def _rank1(L: torch.Tensor, x: torch.Tensor, sign: float) -> torch.Tensor:
    """``L' L'^T = L L^T + sign x x^T`` by Givens (``sign = 1``) or
    hyperbolic (``-1``) rotations, column by column: ``r = sqrt(l_jj^2 +
    sign x_j^2)``, ``c = r / l_jj``, ``s = x_j / l_jj``, then below the
    diagonal ``l_ij' = (l_ij + sign s x_i) / c`` and ``x_i' = c x_i - s
    l_ij'``, eight launches per column."""
    p = L.shape[0]
    if x.dim() == 1:
        x = x[:, None]
    N = torch.broadcast_shapes(L.shape[2:], x.shape[1:])
    xs = torch.broadcast_to(x, (p, *N)).clone()
    out = torch.zeros((p, p, *N), dtype=L.dtype, device=L.device)
    diag = torch.diagonal(L, 0, 0, 1).movedim(-1, 0)  # (p, *N) views of l_jj
    sq = diag * diag
    for j in range(p):
        ljj, xj, r = diag[j], xs[j], out[j, j]
        torch.sqrt(torch.addcmul(sq[j], xj, xj, value=sign), out=r)
        c = r / ljj
        s = xj / ljj
        if j + 1 < p:
            rest, lij = xs[j + 1:], out[j + 1:, j]
            torch.div(torch.addcmul(L[j + 1:, j], s, rest, value=sign), c, out=lij)
            rest.mul_(c).addcmul_(s, lij, value=-1.0)
    return out


def chol_rank1_update_bl(L: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``L' L'^T = L L^T + x x^T``, batch-last: ``L (p, p, N)`` lower,
    ``x (p, N)`` or one vector for every particle, ``(p,)`` or ``(p,
    1)``."""
    return _rank1(L, x, 1.0)


def chol_rank1_downdate_bl(L: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``L' L'^T = L L^T - x x^T``, batch-last (hyperbolic rotations:
    ``r = sqrt(l_jj^2 - x_j^2)``). The caller keeps ``L L^T - x x^T``
    positive definite, as the cSMC's reference-future decrement does (the
    remaining future is a sum of rank-1 terms); where rounding breaks that,
    ``r`` is NaN."""
    return _rank1(L, x, -1.0)


def aug_factorize_bl(nat: mniw.MNIW, jitter: float | None = None):
    """Augmented lower Cholesky of a batch-last MNIW (structured leaves):
    ``(F (p, p, N), df)``, the dtype's relative jitter on the ``T1`` block
    as :func:`~bipk_tpu_torch.ops.mniw.factorize_bl` puts it (once; the
    rank-1 maintenance adds none)."""
    if jitter is None:
        jitter = mniw._default_jitter(nat.T1.dtype)
    m = nat.T1.shape[0]
    T1s = 0.5 * (nat.T1 + nat.T1.transpose(0, 1))
    if jitter:
        trace = torch.diagonal(T1s, 0, 0, 1).sum(-1) / m
        T1s = T1s + (jitter * trace) * torch.eye(m, dtype=T1s.dtype, device=T1s.device)[:, :, None]
    T2s = 0.5 * (nat.T2 + nat.T2.transpose(0, 1))
    M = torch.cat([torch.cat([T1s, nat.T0], 1),
                   torch.cat([nat.T0.transpose(0, 1), T2s], 1)], 0)
    return bla.chol_lower_bl(M), nat.T3


def aug_to_factor(F: torch.Tensor, df: torch.Tensor, m: int) -> mniw.MNIWFactor:
    """An augmented factor as an :class:`~bipk_tpu_torch.ops.mniw.
    MNIWFactor`: ``chol = F[:m, :m]`` and ``white_T0 = F[m:, :m]^T`` are
    views (particle stride 1, read in place by the projection kernel);
    ``row_scale = C C^T``, ``C = F[m:, m:]``."""
    n = F.shape[0] - m
    C = F[m:, m:]
    row_scale = torch.stack([
        torch.stack([sum(C[a, k] * C[b, k] for k in range(min(a, b) + 1)) for b in range(n)])
        for a in range(n)
    ])
    return mniw.MNIWFactor(F[:m, :m], F[m:, :m].transpose(0, 1), row_scale, df)


def aug_log_base_measure(F: torch.Tensor, df: torch.Tensor, m: int) -> torch.Tensor:
    """The MNIW log base measure off an augmented factor's diagonal:
    ``logdet T1 = 2 sum log diag(L)``, ``logdet Psi = 2 sum log diag(C)``
    (the JAX function's arithmetic)."""
    p = F.shape[0]
    n = p - m
    logs = torch.log(torch.diagonal(F, 0, 0, 1))  # (N, p)
    half_ld_t1 = logs[..., :m].sum(-1)
    half_ld_psi = logs[..., m:].sum(-1)
    nu = df
    out = -0.5 * n * m * math.log(2.0 * math.pi) + n * half_ld_t1
    out = out - (0.5 * n * math.log(2.0)) * nu
    out = out - mniw.multigammaln(0.5 * nu, n)
    return out + nu * half_ld_psi
