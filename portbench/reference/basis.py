"""Reduced-rank (Hilbert-space) GP bases, from their definition.

The Laplace eigenfunctions of a box ``[c - L, c + L]`` are
``prod_d sqrt(1/L_d) sin(sqrt(lambda_d) (x_d - c_d + L_d))`` with
``sqrt(lambda_d) = pi j_d / (2 L_d)``; the prior variance of each
coefficient is the squared-exponential spectral density at
``sqrt(lambda)``. Which index tuples ``j`` are kept is a choice of the
model: the ``count`` tuples of least ``sum_d w_d j_d^2``, ``w_d = (pi /
2 L_d)^2``, over candidate indices ``start, start + step, ...``, ties
broken by the tuple. The selection below is a frozen copy of that rule's
best-first walk, so that the reference orders the basis functions as the
model's source does: the packed statistics are read row by row.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch


def select_indices(candidates: np.ndarray, weights: np.ndarray, count: int) -> np.ndarray:
    """``(count, dims)`` index tuples of least ``sum_d w_d j_d^2``."""
    dims = weights.shape[0]
    sq = candidates.astype(np.float64) ** 2

    def cost(pos):
        return float(np.dot(weights, sq[list(pos)]))

    origin = (0,) * dims
    frontier = [(cost(origin), origin)]
    seen = {origin}
    chosen = []
    while frontier and len(chosen) < count:
        _, pos = heapq.heappop(frontier)
        chosen.append(candidates[list(pos)])
        for d in range(dims):
            if pos[d] + 1 >= len(candidates):
                continue
            nxt = pos[:d] + (pos[d] + 1,) + pos[d + 1:]
            if nxt not in seen:
                seen.add(nxt)
                heapq.heappush(frontier, (cost(nxt), nxt))
    if len(chosen) < count:
        raise ValueError(f"only {len(chosen)} index tuples for {count} basis functions")
    return np.stack(chosen).astype(np.float64)


class Basis:
    """``m`` eigenfunctions on a box; :meth:`__call__` maps ``(d, N)`` points
    to ``(N, m)`` features (batch first)."""

    def __init__(self, count, domain, lengthscale, magnitude, idx_start=1, idx_step=1):
        domain = np.atleast_2d(np.asarray(domain, np.float64))
        self.centers = (domain[:, 0] + domain[:, 1]) / 2.0
        sizes = domain[:, 1] - domain[:, 0]
        self.half = sizes / 2.0
        start = max(int(idx_start), 1)
        cand = np.arange(start, count * idx_step + 1 + start, idx_step, dtype=np.int64)
        idx = select_indices(cand, (np.pi / sizes) ** 2, count)
        self.freq = np.pi * idx / sizes[None, :]  # (m, d)
        ls = np.broadcast_to(np.asarray(lengthscale, np.float64), self.freq.shape)
        dims = self.freq.shape[1]
        self.spectral_density = (magnitude * (2.0 * np.pi) ** (dims / 2.0) * np.prod(ls, -1)
                                 * np.exp(-0.5 * np.sum((ls * self.freq) ** 2, -1)))
        self.norm = float(np.prod(np.sqrt(1.0 / self.half)))
        self.m = count

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``x (d, N)`` or ``(N,)`` -> features ``(N, m)``."""
        if x.dim() == 1:
            x = x[None]
        freq = torch.as_tensor(self.freq, dtype=x.dtype, device=x.device)  # (m, d)
        shift = torch.as_tensor(self.half - self.centers, dtype=x.dtype, device=x.device)
        arg = freq[None, :, :] * (x.T + shift)[:, None, :]  # (N, m, d)
        return self.norm * torch.prod(torch.sin(arg), -1)
