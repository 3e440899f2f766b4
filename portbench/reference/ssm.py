"""What the configurations' models share, written out from their equations;
each model is a file of its own, ``models/<model>.py``, found by the name a
configuration file gives under ``"model"``.

Each model is a state-space model ``x' = f(x, u, g) + chol(Q) z``, ``y =
h(x, u, g) + noise(R)`` with RK4 over one step of ``dt``, in which
``g`` are the values of the unknown functions (the GPs), each learned on
the features of its own basis. Batch last: states ``(dx, N)``, GP values
a list of ``(N, n)``, inputs ``(du,)`` for every particle or ``(du, N)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.basis import Basis
from portbench.reference.mniw import Prior


def rk4(rhs, x, dt, *args):
    k1 = rhs(x, *args)
    k2 = rhs(x + 0.5 * dt * k1, *args)
    k3 = rhs(x + 0.5 * dt * k2, *args)
    k4 = rhs(x + dt * k3, *args)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


class GP:
    def __init__(self, basis: Basis, prior: Prior, n: int, features):
        self.basis, self.prior, self.n, self.m = basis, prior, n, basis.m
        self.features = features  # (x (dx, N), u) -> the basis's input points


class Model:
    """Common parts: noise factors, the Gaussian log likelihood, the
    propagation and every GP's features."""

    def chol_q(self, like):
        return torch.as_tensor(np.linalg.cholesky(self.Q), dtype=like.dtype, device=like.device)

    def loglik(self, y, x, u, g):
        """Gaussian log density of the observation ``y (dy,)`` per particle
        (``R`` is diagonal in both configurations)."""
        h = self.output(x, u, g)  # (dy, N)
        var = torch.as_tensor(np.diag(self.R).copy(), dtype=h.dtype, device=h.device)[:, None]
        r = y.to(h.dtype).reshape(-1, 1) - h
        dy = h.shape[0]
        return (-0.5 * (dy * math.log(2.0 * math.pi) + (r * r / var).sum(0))
                - 0.5 * torch.log(var).sum())

    def phi(self, i, x, u):
        return self.gps[i].basis(self.gps[i].features(x, u))
