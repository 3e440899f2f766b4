"""Small-matrix linear algebra (port of ``bipk_tpu/ops/batched_linalg.py``).

The batch-last helpers take ``(m, m, N)`` matrices with the particle batch
LAST, as in the JAX package, so the packed statistics and every
per-particle tensor compare element for element. The loops run over the
small matrix dimension and each iteration is one vectorized op over
``(·, N)``. The unbatched functions (``chol_lower``, ``solve_lower``,
``solve_lower_t``, ``cho_solve``, ``logdet_from_chol``) take one matrix and
run the same loops on a batch of one.
"""

from __future__ import annotations

import torch


def _row_times(Lrow: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``sum_k Lrow[k] * X[k]`` where ``Lrow`` is ``(k,)`` (constant
    factor) or ``(k, N)`` and ``X`` is ``(k, N)`` or ``(k, r, N)``."""
    if Lrow.dim() == 1:
        Lrow = Lrow.reshape((-1,) + (1,) * (X.dim() - 1))
    elif X.dim() == 3:
        Lrow = Lrow[:, None, :]
    return (Lrow * X).sum(0)


def chol_lower(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of one SPD ``(m, m)`` matrix (NaN where it fails, as
    the JAX package's unrolled factorization)."""
    return chol_lower_bl(A[..., None])[..., 0]


def solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Forward substitution ``L x = b``; ``b`` is ``(m,)`` or ``(m, r)``."""
    return solve_lower_bl(L, b[..., None])[..., 0]


def solve_lower_t(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Back substitution ``L^T x = b``; ``b`` is ``(m,)`` or ``(m, r)``."""
    return solve_lower_t_bl(L, b[..., None])[..., 0]


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L L^T x = b`` from the lower factor."""
    return solve_lower_t(L, solve_lower(L, b))


def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    """``log det(A) = 2 sum(log(diag(chol(A))))`` of one ``(m, m)`` factor."""
    return 2.0 * torch.log(torch.diagonal(L, 0, -2, -1)).sum(-1)


def chol_lower_bl(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky, batch-last: ``A (m, m, N) -> L (m, m, N)``.

    Column ``j`` is ``(A[j:, j] - sum_{k<j} L[j:, k] L[j, k]) *
    rsqrt(diag)``, as ``chol_lower_bl`` in the JAX package."""
    m = A.shape[0]
    L = torch.zeros_like(A)
    for j in range(m):
        s = A[j:, j]
        if j:
            s = s - (L[j:, :j] * L[j, :j]).sum(1)
        L[j:, j] = s * torch.rsqrt(s[0])
    return L


def solve_lower_bl(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Forward substitution ``L x = b``, batch-last.

    ``L (m, m, N)`` (or constant ``(m, m)``), ``b (m, N)`` or ``(m, r, N)``.
    """
    m = L.shape[0]
    x = torch.empty_like(b)
    for i in range(m):
        acc = b[i]
        if i:
            acc = acc - _row_times(L[i, :i], x[:i])
        x[i] = acc / L[i, i]
    return x


def solve_lower_t_bl(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Back substitution ``L^T x = b``, batch-last."""
    m = L.shape[0]
    x = torch.empty_like(b)
    for i in range(m - 1, -1, -1):
        acc = b[i]
        if i < m - 1:
            acc = acc - _row_times(L[i + 1 :, i], x[i + 1 :])
        x[i] = acc / L[i, i]
    return x


def logdet_from_chol_bl(L: torch.Tensor) -> torch.Tensor:
    """``(m, m, N) -> (N,)`` log-determinants ``2 sum log diag(L)``."""
    return 2.0 * torch.log(torch.diagonal(L, 0, 0, 1)).sum(-1)
