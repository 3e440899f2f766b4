"""State-space model and learned-function (GP node) descriptions (port of
``bipk_tpu/models/ssm.py``).

Build-time descriptions: the callables are batch-last torch functions and
the noise covariances and priors are host-side numpy arrays, moved to a
device with :meth:`SSM.process_chol` / :meth:`GPNode.prior_as`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from bipk_tpu_torch.ops.mniw import MNIW


@dataclasses.dataclass(frozen=True)
class SSM:
    """Nonlinear state-space model with injected interface variables.

    ``transition(x, u, *int_vars) -> x_next`` and ``output(x, u,
    *int_vars) -> y`` take batch-last states ``(dx, N)`` and interface
    variables ``(n_i, N)``, and an input ``u`` that is ``(du,)`` for every
    column or ``(du, N)``, one per column (the traces' outputs are
    evaluated for all time points at once); the Gaussian process/output
    noises are fixed covariances.
    """

    transition: Callable[..., torch.Tensor]
    output: Callable[..., torch.Tensor]
    process_noise: np.ndarray
    output_noise: np.ndarray

    @property
    def state_dim(self) -> int:
        return int(np.atleast_2d(self.process_noise).shape[0])

    @property
    def is_deterministic(self) -> bool:
        return bool(np.all(np.asarray(self.process_noise) == 0))

    def process_chol(self, dtype, device) -> torch.Tensor:
        return _chol(self.process_noise, dtype, device)

    def output_chol(self, dtype, device) -> torch.Tensor:
        return _chol(self.output_noise, dtype, device)


def _chol(cov, dtype, device) -> torch.Tensor:
    return torch.as_tensor(
        np.linalg.cholesky(np.atleast_2d(np.asarray(cov, np.float64))),
        dtype=dtype, device=device,
    )


@dataclasses.dataclass(frozen=True)
class GPNode:
    """One unknown sub-function learned with a basis-expansion GP prior.

    ``basis_fn_bl(x (dx, N), u (du,) or (du, N)) -> phi (m, N)``, the
    input shared by every column or one per column; ``prior`` is the
    MNIW prior in natural form (numpy leaves); ``init_mean`` / ``init_cov``
    parameterize the Gaussian draw of the initial interface variables.
    """

    basis_fn_bl: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    prior: MNIW
    init_mean: np.ndarray
    init_cov: np.ndarray

    @property
    def out_dim(self) -> int:
        return int(np.atleast_1d(self.init_mean).shape[0])

    @property
    def basis_dim(self) -> int:
        return int(np.asarray(self.prior.T1).shape[0])

    def prior_as(self, dtype, device) -> MNIW:
        return MNIW(*(
            torch.as_tensor(np.asarray(p, np.float64), dtype=dtype, device=device)
            for p in self.prior
        ))

    def init_chol(self, dtype, device) -> torch.Tensor:
        return _chol(self.init_cov, dtype, device)
