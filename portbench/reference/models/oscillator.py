"""The oscillator configuration's model (``configs/oscillator.json``)."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.basis import Basis
from portbench.reference.mniw import prior_from_standard
from portbench.reference.ssm import GP, Model, rk4


class Oscillator(Model):
    """A mass on a spring and damper, state ``(position, velocity)``,
    input the external force, the spring-damper force the unknown function
    of the state, observed through the position."""

    def __init__(self, cfg: dict):
        self.mass = cfg["physics"]["mass"]
        self.dt = cfg["dt"]
        self.Q = np.asarray(cfg["process_noise"], np.float64)
        self.R = np.asarray(cfg["output_noise"], np.float64)
        d = cfg["domain"]
        basis = Basis(cfg["n_basis"], [[-d, d], [-d, d]], 2.0 * d / cfg["n_basis"],
                      cfg["magnitude"])
        prior = prior_from_standard(np.zeros((1, basis.m)), np.diag(basis.spectral_density),
                                    np.eye(1), cfg["prior_df"])
        self.gps = [GP(basis, prior, 1, lambda x, u: x)]

    def _rhs(self, x, f_ext, f_sd):
        return torch.stack([x[1], (f_ext - f_sd) / self.mass])

    def transition(self, x, u, g):
        return rk4(self._rhs, x, self.dt, u[0], g[0][:, 0])

    def output(self, x, u, g):
        return x[:1]


def build(cfg: dict) -> Model:
    return Oscillator(cfg)
