"""Systematic resampling (port of ``bipk_tpu/ops/resampling.py``:
``normalize_weights`` and the closed-form-counts ``systematic``).

:func:`systematic` is the plain version of the CUDA kernel behind
``cuda_kernels.systematic_ancestors_blocks``.
"""

from __future__ import annotations

import torch


def normalize_weights(weights: torch.Tensor) -> torch.Tensor:
    """Clip to non-negative and normalize; uniform fallback on zero mass."""
    n = weights.shape[-1]
    w = torch.clamp(weights, min=0.0)
    total = w.sum(-1, keepdim=True)
    return torch.where(total > 0, w / total, torch.full_like(w, 1.0 / n))


def systematic(weights: torch.Tensor, u) -> torch.Tensor:
    """Sorted systematic-resampling ancestors ``(N,)`` int32.

    ``weights`` are unnormalized non-log weights, ``u`` the shared uniform
    offset in ``[0, 1)`` (a float or a one-element tensor). Input ``i``
    owns the grid points ``(u + k)/n < cdf_i``, so its cumulative
    offspring count is ``cc_i = clip(ceil(n cdf_i - u), 0, n)`` and
    ``anc[k] = #{i < n-1 : cc_i <= k}``.
    """
    n = weights.shape[-1]
    w = normalize_weights(weights)
    if isinstance(u, torch.Tensor):
        u = u.reshape(())
    cdf = torch.cumsum(w, -1)
    counts_cum = torch.clamp(torch.ceil(n * cdf - u), 0, n).long()
    starts = torch.cat([counts_cum.new_zeros(1), counts_cum[:-1]])
    # starts == n (inputs after the mass is exhausted) fall off the end
    # and are dropped, as the JAX scatter does with mode="drop"
    marker = torch.zeros(n + 1, dtype=torch.long, device=w.device)
    marker.index_add_(0, starts, torch.ones_like(starts))
    anc = torch.cumsum(marker[:n], 0) - 1
    return torch.clamp(anc, 0, n - 1).to(torch.int32)
