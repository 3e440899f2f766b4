"""MCMC convergence diagnostics for multi-chain Gibbs runs (port of
``bipk_tpu/utils/diagnostics.py``).

With chain-parallel sampling (``build_gibbs(..., n_chains=C)``: C
independent chains on one device) the standard cross-chain diagnostics
become available:

- :func:`split_rhat`: the potential scale reduction factor
  (Gelman-Rubin), computed on split chains so that within-chain
  non-stationarity shows even with few chains;
- :func:`rank_normalized_rhat`: the Vehtari et al. (2021) variant, on
  rank-normalized draws, so heavy tails and scale differences cannot
  mask mixing failures; :func:`rhat` takes the larger of it and its
  folded form;
- :func:`ess_mean`: the bulk effective sample size from chain-averaged
  autocorrelations (Geyer's initial-positive-sequence truncation).

Every function takes draws shaped ``(n_chains, n_draws, ...)`` (tensors
or arrays) and reduces the first two axes, returning a float64 CPU tensor
of the trailing shape. They are host-side post-processing, not hot-path
code: the draws are moved to the CPU first.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import stats as _sps


def _host(draws) -> torch.Tensor:
    """``draws`` as a float64 tensor on the CPU."""
    if isinstance(draws, torch.Tensor):
        return draws.detach().to("cpu", torch.float64)
    return torch.as_tensor(np.asarray(draws, dtype=np.float64))


def _split(draws) -> torch.Tensor:
    """Split each chain in half: (C, K, ...) -> (2C, K//2, ...)."""
    draws = _host(draws)
    c, k = draws.shape[:2]
    half = k // 2
    draws = draws[:, : 2 * half]
    return draws.reshape((2 * c, half) + tuple(draws.shape[2:]))


def split_rhat(draws) -> torch.Tensor:
    """Split-chain potential scale reduction factor.

    ``draws`` is ``(n_chains, n_draws, ...)``; returns the trailing shape.
    Values near 1 say the chains agree; above 1.01 is the usual "keep
    sampling" threshold (Vehtari et al. 2021).
    """
    x = _split(draws)
    k = x.shape[1]
    if k < 2:
        raise ValueError(f"need at least 4 draws per chain, got {tuple(_host(draws).shape)}")
    chain_mean = x.mean(1)  # (2C, ...)
    chain_var = x.var(1, correction=1)  # (2C, ...)
    between = k * chain_mean.var(0, correction=1)
    within = chain_var.mean(0)
    var_plus = (k - 1) / k * within + between / k
    return torch.sqrt(var_plus / within.clamp(min=1e-300))


def rank_normalized_rhat(draws, folded: bool = False) -> torch.Tensor:
    """Split-R-hat of rank-normalized draws (Vehtari et al. 2021, eq. 14).

    Pools all draws, replaces each by its normal score
    ``Phi^{-1}((rank - 3/8) / (S + 1/4))``, then computes :func:`split_rhat`
    on the transformed chains. Robust to heavy tails. With ``folded=True``
    the draws are first folded around the pooled median
    (``|x - median|``), which turns a *scale* disagreement between chains
    into a *location* disagreement that R-hat sees.
    """
    x = _host(draws).numpy()
    if folded:
        x = np.abs(x - np.median(x.reshape(-1, *x.shape[2:]), axis=0))
    flat = x.reshape(-1, *x.shape[2:])
    s = flat.shape[0]
    ranks = _sps.rankdata(flat, axis=0, method="average")
    z = _sps.norm.ppf((ranks - 0.375) / (s + 0.25))
    return split_rhat(z.reshape(x.shape))


def rhat(draws) -> torch.Tensor:
    """The Vehtari et al. (2021) convergence summary: the elementwise
    maximum of the rank-normalized split-R-hat (location mixing) and its
    folded variant (scale and tail mixing). Keep sampling while it
    exceeds ~1.01."""
    return torch.maximum(rank_normalized_rhat(draws), rank_normalized_rhat(draws, folded=True))


def gibbs_chain_summary(int_vars, n_burn: int) -> list:
    """Convergence summary of a chain-parallel ``GibbsResult``.

    ``int_vars`` is the result's tuple of interface-variable traces, each
    ``(C, T, K, n_i)``; the scalar summary per draw is the trajectory mean
    of the first component. Returns one dict per learned function:
    ``{"rhat", "ess", "n_draws", "stuck"}`` over the post-burn-in draws.
    Runs too short to diagnose (fewer than 4 post-burn-in draws per chain:
    split R-hat needs 2 per half) report NaNs rather than raising:
    summarizing a finished sampling run must never crash it.
    """
    out = []
    for v in int_vars:
        draws = _host(v)[:, :, n_burn:, 0].mean(1).numpy()  # (C, K - burn)
        # constant draws (every chain glued to its reference) make R-hat
        # 0/0: the conditional SMC is degenerate at this particle count;
        # say so rather than report a NaN
        stuck = bool(np.ptp(draws) == 0.0)
        too_short = draws.shape[1] < 4
        out.append({
            "rhat": float("nan") if stuck or too_short else float(rhat(draws)),
            "ess": float("nan") if stuck or too_short else float(ess_mean(draws)),
            "n_draws": int(draws.size),
            "stuck": stuck,
        })
    return out


def ess_mean(draws) -> torch.Tensor:
    """Bulk effective sample size across chains.

    Chain-averaged autocorrelations with Geyer's initial-positive-sequence
    truncation: consecutive autocorrelation pairs are summed until a pair
    is no longer positive. ``draws`` is ``(n_chains, n_draws, ...)``.
    """
    x = _host(draws).numpy()
    c, k = x.shape[:2]
    trail = x.shape[2:]
    x2 = x.reshape(c, k, -1)
    out = np.empty(x2.shape[2])
    for q in range(x2.shape[2]):
        xc = x2[:, :, q]
        chain_var = xc.var(axis=1, ddof=1)
        w = chain_var.mean()
        b_over_k = xc.mean(axis=1).var(ddof=1) if c > 1 else 0.0
        var_plus = (k - 1) / k * w + b_over_k
        if var_plus <= 0:
            out[q] = c * k
            continue
        xm = xc - xc.mean(axis=1, keepdims=True)
        # FFT autocovariance per chain (biased, /k, as in Stan)
        nfft = 1 << (2 * k - 1).bit_length()
        f = np.fft.rfft(xm, nfft, axis=1)
        acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :k] / k
        # rho_t = 1 - (W - mean_chain_acov_t) / var_plus (Stan's estimator)
        rho = 1.0 - (w - acov.mean(axis=0)) / var_plus
        # Geyer: add rho[t] + rho[t+1] while the pair stays positive
        tau = rho[0]  # 1 up to the ddof correction
        t = 1
        while t + 1 < k:
            pair = rho[t] + rho[t + 1]
            if pair <= 0:
                break
            tau += 2.0 * pair
            t += 2
        out[q] = c * k / max(tau, 1.0 / (c * k))
    return torch.as_tensor(out.reshape(trail) if trail else out[0], dtype=torch.float64)
