"""The vehicle configuration's model (``configs/vehicle.json``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.basis import Basis
from portbench.reference.mniw import prior_from_standard
from portbench.reference.ssm import GP, Model, rk4


class Vehicle(Model):
    """Single-track lateral dynamics, state ``(yaw rate, lateral
    velocity)``, input ``(steering angle, speed)``, the front and rear
    lateral friction ``mu_f, mu_r`` the unknown functions of the slip
    angles, observed through ``tanh`` of yaw rate and lateral
    acceleration."""

    def __init__(self, cfg: dict):
        p = cfg["physics"]
        self.mass, self.izz, self.lf, self.lr = p["mass"], p["inertia_zz"], p["l_front"], p["l_rear"]
        self.mu_x = p["mu_x"]
        mg = p["mass"] * p["gravity"]
        self.fzf = mg * self.lr / (self.lf + self.lr)
        self.fzr = mg * self.lf / (self.lf + self.lr)
        self.dt = cfg["dt"]
        self.Q = np.asarray(cfg["process_noise"], np.float64)
        self.R = np.asarray(cfg["output_noise"], np.float64)
        rad = math.pi / 180.0
        basis = Basis(cfg["n_basis"], [[-cfg["domain_deg"] * rad, cfg["domain_deg"] * rad]],
                      cfg["lengthscale_deg"] * rad, cfg["magnitude"], idx_start=2, idx_step=2)
        prior = prior_from_standard(np.zeros((1, basis.m)), np.diag(basis.spectral_density),
                                    np.eye(1), cfg["prior_df"])
        self.gps = [GP(basis, prior, 1, lambda x, u: self.slip(x, u)[0]),
                    GP(basis, prior, 1, lambda x, u: self.slip(x, u)[1])]

    def slip(self, x, u):
        a_f = u[0] - torch.atan((x[1] + x[0] * self.lf) / u[1])
        a_r = -torch.atan((x[1] - x[0] * self.lr) / u[1])
        return a_f, a_r

    def _accel(self, x, u, mf, mr):
        return ((self.fzf * mf * torch.cos(u[0]) + self.fzr * mr
                 + self.fzf * self.mu_x * torch.sin(u[0])) / self.mass - u[1] * x[0])

    def _rhs(self, x, u, mf, mr):
        ddpsi = (self.lf * self.fzf * mf * torch.cos(u[0]) - self.lr * self.fzr * mr
                 + self.lf * self.fzf * self.mu_x * torch.sin(u[0])) / self.izz
        return torch.stack([ddpsi, self._accel(x, u, mf, mr)])

    def transition(self, x, u, g):
        return rk4(self._rhs, x, self.dt, u, g[0][:, 0], g[1][:, 0])

    def output(self, x, u, g):
        return torch.tanh(torch.stack([x[0], self._accel(x, u, g[0][:, 0], g[1][:, 0])]))


def build(cfg: dict) -> Model:
    return Vehicle(cfg)
