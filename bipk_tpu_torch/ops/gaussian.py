"""Gaussian helpers (port of ``bipk_tpu/ops/gaussian.py``: ``student_t``
and ``mvn_logpdf_chol``). Student-t draws take their uniforms as inputs,
so a draw is a deterministic function of its inputs — the CUDA kernels and
the JAX package can then be fed the same numbers."""

from __future__ import annotations

import math

import torch

from bipk_tpu_torch.ops import batched_linalg as bla

_LOG_2PI = math.log(2.0 * math.pi)


def mvn_logpdf_chol(x, mean, chol_cov: torch.Tensor, log_det_chol=None) -> torch.Tensor:
    """Multivariate-normal log density from a lower Cholesky factor
    ``chol_cov (d, d)``. ``x`` and ``mean`` are ``(d,)`` (a scalar result)
    or batch-last ``(d, N)`` (an ``(N,)`` result), and broadcast against
    each other. ``log_det_chol``, ``sum(log(diag(chol_cov)))``, may be
    passed in by a caller that evaluates the same factor every step."""
    x = torch.atleast_1d(x)
    mean = torch.atleast_1d(mean)
    chol_cov = torch.atleast_2d(chol_cov)
    dim = chol_cov.shape[-1]
    white = bla.solve_lower_bl(chol_cov, x - mean)
    if log_det_chol is None:
        log_det_chol = torch.log(torch.diagonal(chol_cov)).sum()
    return -0.5 * (dim * _LOG_2PI + (white * white).sum(0)) - log_det_chol


def student_t(df: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact ``t_df`` draws from two uniforms ``u, v`` in ``[0, 1)``.

    ``t = sqrt(df (w^{-2/df} - 1)) cos(2 pi v)`` with ``w = 1 - u`` in
    ``(0, 1]``: the JAX package draws ``u`` with ``jax.random.uniform`` and
    takes ``1 - u`` (``w = 0`` would overflow ``w^{-2/df}``), and the CUDA
    kernels take the same raw ``u``. ``df`` broadcasts against ``u``.
    """
    w = 1.0 - u
    r = torch.sqrt(df * torch.expm1(-(2.0 / df) * torch.log(w)))
    return r * torch.cos((2.0 * math.pi) * v)
