"""Hilbert-space (reduced-rank) GP basis functions (port of
``bipk_tpu/ops/basis.py``).

Laplace eigenfunctions of a box domain, ``prod_d sqrt(1/L_d) sin(sqrt(
lambda_d) (x_d + L_d))`` on the centred domain, with the squared-
exponential spectral density at the eigenfrequencies as the prior
coefficient variances. The index selection runs on the host in numpy
(a copy of the JAX package's heapq walk); evaluation is batch-last torch.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch


def _lowest_index_combinations(
    per_dim_indices: np.ndarray, weights: np.ndarray, count: int
) -> np.ndarray:
    """Select the ``count`` index tuples minimizing ``sum_d w_d j_d^2`` by a
    lazy best-first walk of the (monotone) index lattice."""
    dims = weights.shape[0]
    sq = per_dim_indices.astype(np.float64) ** 2

    def cost(pos: tuple) -> float:
        return float(np.dot(weights, sq[list(pos)]))

    origin = (0,) * dims
    frontier: list[tuple[float, tuple]] = [(cost(origin), origin)]
    seen = {origin}
    chosen: list[np.ndarray] = []
    limit = len(per_dim_indices)

    while frontier and len(chosen) < count:
        _, pos = heapq.heappop(frontier)
        chosen.append(per_dim_indices[list(pos)])
        for d in range(dims):
            if pos[d] + 1 >= limit:
                continue
            nxt = pos[:d] + (pos[d] + 1,) + pos[d + 1 :]
            if nxt in seen:
                continue
            seen.add(nxt)
            heapq.heappush(frontier, (cost(nxt), nxt))

    if len(chosen) < count:
        raise ValueError(
            f"index lattice exhausted: wanted {count} combinations, "
            f"got {len(chosen)}"
        )
    return np.stack(chosen).astype(np.float64)


def se_spectral_density(freq, magnitude, lengthscale) -> np.ndarray:
    """Spectral density of the squared-exponential kernel,
    ``magnitude (2 pi)^{D/2} prod_d l_d exp(-0.5 sum_d l_d^2 w_d^2)``;
    ``freq`` is ``(..., D)``."""
    freq = np.atleast_2d(np.asarray(freq, dtype=np.float64))
    dims = freq.shape[-1]
    ls = np.broadcast_to(np.asarray(lengthscale, dtype=np.float64), freq.shape)
    amplitude = magnitude * (2.0 * np.pi) ** (dims / 2.0) * np.prod(ls, axis=-1)
    return amplitude * np.exp(-0.5 * np.sum((ls * freq) ** 2, axis=-1))


class HilbertBasis:
    """A constructed basis: host-side constants plus the batch-last feature
    map :meth:`eigen_fn_bl`. The constants are copied to each (device,
    dtype) once and kept, so evaluation makes no host-to-device copy."""

    def __init__(self, sqrt_eigenvalues, centers, half_widths, spectral_density):
        self.sqrt_eigenvalues = np.asarray(sqrt_eigenvalues, np.float64)  # (m, d)
        self.centers = np.asarray(centers, np.float64)  # (d,)
        self.half_widths = np.asarray(half_widths, np.float64)  # (d,)
        self.spectral_density = np.asarray(spectral_density, np.float64)  # (m,)
        self._consts: dict = {}

    @property
    def norm_val(self) -> float:
        return float(np.prod(np.sqrt(1.0 / self.half_widths)))

    def _on(self, device, dtype):
        key = (device, dtype)
        if key not in self._consts:
            self._consts[key] = (
                torch.as_tensor(self.sqrt_eigenvalues, dtype=dtype, device=device)[:, :, None],
                torch.as_tensor(self.half_widths - self.centers, dtype=dtype, device=device)[:, None],
            )
        return self._consts[key]

    def eigen_fn_bl(self, x_bl: torch.Tensor) -> torch.Tensor:
        """Batch-last eigenfunction evaluation: ``(d, N)`` or ``(N,)`` ->
        ``(m, N)``."""
        if x_bl.dim() == 1:
            x_bl = x_bl[None, :]
        sqrt_eig, shift = self._on(x_bl.device, x_bl.dtype)
        shifted = x_bl + shift  # position in [0, 2L]
        prods = torch.prod(torch.sin(sqrt_eig * shifted[None, :, :]), dim=1)
        return self.norm_val * prods


def make_hilbert_basis(
    num_fcn: int,
    domain,
    lengthscale,
    magnitude,
    idx_start: int = 1,
    idx_step: int = 1,
) -> HilbertBasis:
    """Build a Hilbert-GP basis on a box ``domain`` of shape ``(dims, 2)``,
    with the same index span and ``idx_start``/``idx_step`` selection as
    ``make_hilbert_basis`` in the JAX package."""
    domain = np.atleast_2d(np.asarray(domain, dtype=np.float64))
    centers = (domain[:, 0] + domain[:, 1]) / 2.0
    sizes = domain[:, 1] - domain[:, 0]
    start = max(int(idx_start), 1)
    candidates = np.arange(
        start, num_fcn * idx_step + 1 + start, idx_step, dtype=np.int64
    )
    index_mat = _lowest_index_combinations(candidates, (np.pi / sizes) ** 2, num_fcn)
    sqrt_eig = np.pi * index_mat / sizes[None, :]
    return HilbertBasis(
        sqrt_eig, centers, sizes / 2.0,
        se_spectral_density(sqrt_eig, magnitude, lengthscale),
    )
