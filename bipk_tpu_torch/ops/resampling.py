"""Particle resampling (port of ``bipk_tpu/ops/resampling.py``:
``normalize_weights``, the closed-form-counts ``systematic``, the single
categorical draw, the ESS and the backward ancestral reconstruction).

:func:`systematic` is the plain version of the CUDA kernel behind
``cuda_kernels.systematic_ancestors_blocks``. Every uniform is an input.
"""

from __future__ import annotations

import torch


def normalize_weights(weights: torch.Tensor) -> torch.Tensor:
    """Clip to non-negative and normalize; uniform fallback on zero mass."""
    n = weights.shape[-1]
    w = torch.clamp(weights, min=0.0)
    total = w.sum(-1, keepdim=True)
    return torch.where(total > 0, w / total, torch.full_like(w, 1.0 / n))


def _cdf(w: torch.Tensor) -> torch.Tensor:
    """The float64 prefix sums of ``w``. On a card ``torch.cumsum`` is a
    parallel scan, and its prefix sums are not monotone: two neighbours'
    prefixes round through different additions, so a particle of zero
    weight can take a one-ulp step of the CDF, and with it a draw, with
    probability N ulp (~2e-3 per particle at N = 32768 in float32, ~4e-12
    in float64)."""
    return torch.cumsum(w, -1, dtype=torch.float64)


def systematic(weights: torch.Tensor, u) -> torch.Tensor:
    """Sorted systematic-resampling ancestors ``(N,)`` int32.

    ``weights`` are unnormalized non-log weights, ``u`` the shared uniform
    offset in ``[0, 1)`` (a float or a one-element tensor). Input ``i``
    owns the grid points ``(u + k)/n < cdf_i``, so its cumulative
    offspring count is ``cc_i = clip(ceil(n cdf_i - u), 0, n)`` and
    ``anc[k] = #{i < n-1 : cc_i <= k}``. The CDF is summed in float64
    (:func:`_cdf`).
    """
    n = weights.shape[-1]
    w = normalize_weights(weights)
    if isinstance(u, torch.Tensor):
        u = u.reshape(())
    cdf = _cdf(w)
    counts_cum = torch.clamp(torch.ceil(n * cdf - u), 0, n).long()
    starts = torch.cat([counts_cum.new_zeros(1), counts_cum[:-1]])
    # starts == n (inputs after the mass is exhausted) fall off the end
    # and are dropped, as the JAX scatter does with mode="drop"
    marker = torch.zeros(n + 1, dtype=torch.long, device=w.device)
    marker.index_add_(0, starts, torch.ones_like(starts))
    anc = torch.cumsum(marker[:n], 0) - 1
    return torch.clamp(anc, 0, n - 1).to(torch.int32)


def categorical_from_weights(weights: torch.Tensor, u) -> torch.Tensor:
    """One inverse-cdf categorical draw from normalized ``weights (N,)``
    with the uniform ``u`` (a one-element tensor): a 0-d int64 index on
    the weights' device, never read back to the host. The CDF is summed
    in float64 (:func:`_cdf`)."""
    cdf = _cdf(weights)
    u = torch.as_tensor(u, device=weights.device).to(torch.float64)
    idx = torch.searchsorted(cdf, u.reshape(1))
    return torch.clamp(idx, 0, weights.shape[-1] - 1).reshape(())


def effective_sample_size(log_weights: torch.Tensor) -> torch.Tensor:
    """``1 / sum(w_i^2)`` of the normalized ``softmax(log_weights)``."""
    w = torch.softmax(log_weights, -1)
    return 1.0 / (w * w).sum(-1)


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


def backward_indices(ancestry: torch.Tensor, final_index) -> torch.Tensor:
    """``(T,)`` particle indices of one ancestral line: ``idx[T-1] =
    final_index``, ``idx[t] = ancestry[t, idx[t+1]]``."""
    idx = torch.as_tensor(final_index, device=ancestry.device).reshape(1).long()
    out = [idx]
    for t in range(ancestry.shape[0] - 1, -1, -1):
        idx = ancestry[t].index_select(0, idx).long()
        out.append(idx)
    return torch.cat(out[::-1])


def reconstruct_trajectory(particles, ancestry: torch.Tensor, final_index):
    """Follow the ancestors backward to extract one trajectory.

    ``particles`` is a tensor or nested tuple of ``(T, N, ...)`` traces,
    ``ancestry (T-1, N)`` holds the time-``t`` ancestor of each time-``t+1``
    particle. Returns the same structure of ``(T, ...)`` trajectories and
    the ``(T,)`` indices."""
    indices = backward_indices(ancestry, final_index)
    steps = torch.arange(indices.shape[0], device=indices.device)
    return _tree_map(lambda tr: tr[steps, indices], particles), indices


def reconstruct_trajectory_bl(particles, ancestry: torch.Tensor, final_index):
    """:func:`reconstruct_trajectory` of batch-last ``(T, ..., N)``
    traces."""
    indices = backward_indices(ancestry, final_index)
    steps = torch.arange(indices.shape[0], device=indices.device)
    return (
        _tree_map(lambda tr: tr.movedim(-1, 1)[steps, indices], particles),
        indices,
    )
