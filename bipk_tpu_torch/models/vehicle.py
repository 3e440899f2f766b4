"""Lateral vehicle dynamics: single-track model with unknown tire friction
(port of ``bipk_tpu/models/vehicle.py``).

Learns the front and rear lateral friction curves ``mu_y(alpha)`` (two GP
nodes, 20 even-index Hilbert basis functions on +-30 deg) inside a known
single-track skeleton (yaw rate, lateral velocity) with a tanh-squashed
two-dimensional measurement. The physics takes batch-last states
``(2, N)`` and frictions ``(N,)``, or one state ``(2,)`` and scalars.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bipk_tpu_torch._device import resolve_device
from bipk_tpu_torch.models.ssm import GPNode, SSM
from bipk_tpu_torch.ops import basis as basis_ops
from bipk_tpu_torch.ops.integrators import rk4_step
from bipk_tpu_torch.ops.mniw import natural_from_standard

M = 1720.0
I_ZZ = 1827.5
L_F = 1.16
L_R = 1.47
G = 9.81
MU_X = 0.9
MU = 0.9
PACEJKA_B = 10.0
PACEJKA_C = 1.9
PACEJKA_E = 0.97

_MG = M * G
F_ZF = _MG * L_R / (L_F + L_R)
F_ZR = _MG * L_F / (L_F + L_R)


def mu_y_true(alpha):
    """Pacejka-style magic-formula lateral friction."""
    t = torch.tan(alpha)
    return MU * torch.sin(
        PACEJKA_C
        * torch.atan(
            PACEJKA_B * (1.0 - PACEJKA_E) * t
            + PACEJKA_E * torch.atan(PACEJKA_B * t)
        )
    )


def side_slip(x, u):
    """Front/rear side-slip angles from state ``(dpsi, v_y)`` and input
    ``(steering, v_x)``."""
    alpha_f = u[0] - torch.atan((x[1] + x[0] * L_F) / u[1])
    alpha_r = -torch.atan((x[1] - x[0] * L_R) / u[1])
    return alpha_f, alpha_r


def _lateral_accel(x, u, mu_f, mu_r):
    return (
        F_ZF * mu_f * torch.cos(u[0]) + F_ZR * mu_r + F_ZF * MU_X * torch.sin(u[0])
    ) / M - u[1] * x[0]


def _rhs(x, u, mu_f, mu_r):
    dv_y = _lateral_accel(x, u, mu_f, mu_r)
    ddpsi = (
        L_F * F_ZF * mu_f * torch.cos(u[0])
        - L_R * F_ZR * mu_r
        + L_F * F_ZF * MU_X * torch.sin(u[0])
    ) / I_ZZ
    return torch.stack([ddpsi, dv_y])


def transition(x, u, mu_f, mu_r, dt):
    return rk4_step(_rhs, x, dt, u, mu_f, mu_r)


def observe(x, u, mu_f, mu_r):
    """tanh-squashed ``(yaw rate, lateral accel)`` measurement."""
    return torch.tanh(torch.stack([x[0], _lateral_accel(x, u, mu_f, mu_r)]))


@dataclasses.dataclass(frozen=True)
class VehicleConfig:
    n_basis: int = 20
    domain_deg: float = 30.0
    lengthscale_deg: float = 2.0
    magnitude: float = 50.0
    prior_df: float = 0.0
    n_particles: int = 200
    n_gibbs: int = 800
    forgetting_factor: float = 0.999
    dt: float = 0.02
    t_end: float = 30.0
    speed: float = 11.0
    seed: int = 12345678

    @property
    def n_steps(self) -> int:
        return len(np.arange(0.0, self.t_end, self.dt))


@dataclasses.dataclass(frozen=True)
class VehicleModel:
    config: VehicleConfig
    ssm: SSM
    gps: tuple  # (front, rear) GPNode
    basis: basis_ops.HilbertBasis
    x0: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((2,)))
    p0: np.ndarray = dataclasses.field(
        default_factory=lambda: np.diag([1e-4, 1e-4])
    )


R = np.diag([0.001 / 180 * np.pi, 1e-3])
Q = np.diag([1e-8, 1e-8])
P0_MU = np.diag([1e-4])


def steering_profile(config: VehicleConfig) -> np.ndarray:
    """Windowed sinusoidal steering + constant speed ``(T, 2)``."""
    time = np.arange(0.0, config.t_end, config.dt)
    u = np.zeros((config.n_steps, 2))
    u[:, 0] = (
        10.0 / 180.0 * np.pi
        * np.sin(2 * np.pi * time / 5.0)
        * np.exp(-0.5 * (time - config.t_end / 2) ** 2 / (config.t_end / 5) ** 2)
    )
    u[:, 1] = config.speed
    return u


def model_from_parts(
    config: VehicleConfig, hb: basis_ops.HilbertBasis, priors,
    process_noise=Q, output_noise=R, init_cov=P0_MU, **initial,
) -> VehicleModel:
    """Assemble the vehicle model from its basis and the two GP priors."""

    def basis_front_bl(state, inp):
        return hb.eigen_fn_bl(side_slip(state, inp)[0])

    def basis_rear_bl(state, inp):
        return hb.eigen_fn_bl(side_slip(state, inp)[1])

    dt = config.dt
    ssm = SSM(
        transition=lambda state, inp, *iv: transition(state, inp, iv[0][0], iv[1][0], dt),
        output=lambda state, inp, *iv: observe(state, inp, iv[0][0], iv[1][0]),
        process_noise=np.asarray(process_noise),
        output_noise=np.asarray(output_noise),
    )
    gps = tuple(
        GPNode(basis_fn_bl=fn, prior=prior, init_mean=np.zeros(1),
               init_cov=np.asarray(init_cov))
        for fn, prior in zip((basis_front_bl, basis_rear_bl), priors)
    )
    return VehicleModel(config=config, ssm=ssm, gps=gps, basis=hb, **initial)


def make_model(config: VehicleConfig = VehicleConfig()) -> VehicleModel:
    rad = np.pi / 180.0
    hb = basis_ops.make_hilbert_basis(
        config.n_basis,
        np.array([-config.domain_deg * rad, config.domain_deg * rad]),
        config.lengthscale_deg * rad,
        config.magnitude,
        idx_start=2,
        idx_step=2,
    )
    prior = natural_from_standard(
        np.zeros((1, config.n_basis)), np.diag(hb.spectral_density),
        np.eye(1), config.prior_df,
    )
    return model_from_parts(config, hb, (prior, prior))


def simulate(
    generator: torch.Generator, config: VehicleConfig = VehicleConfig(),
    dtype=torch.float32, device="cuda",
):
    """Synthetic data from the true (Pacejka) friction curves.

    Draws the process and measurement noise from ``generator`` (a CPU
    generator), integrates on the CPU and returns, on ``device`` (CUDA
    unless the caller asks for the CPU),
    ``(states (T, 2), observations (T, 2), mu_front (T,), mu_rear (T,),
    inputs (T, 2))`` with ``observations[0] = 0``, as the JAX ``simulate``.
    """
    device = resolve_device(device)
    T = config.n_steps
    ctrl = torch.as_tensor(steering_profile(config), dtype=dtype)
    chol_q = torch.as_tensor(np.linalg.cholesky(Q), dtype=dtype)
    r_std = torch.as_tensor(np.sqrt(np.diag(R)), dtype=dtype)
    noise = torch.randn((T - 1, 2, 2), generator=generator, dtype=dtype)
    x = torch.zeros(2, dtype=dtype)
    mu = side_slip(x, ctrl[0])
    mu_f, mu_r = mu_y_true(mu[0]), mu_y_true(mu[1])
    states, obs, mus_f, mus_r = [x], [torch.zeros(2, dtype=dtype)], [mu_f], [mu_r]
    for t in range(T - 1):
        x = transition(x, ctrl[t], mu_f, mu_r, config.dt) + chol_q @ noise[t, 0]
        a_f, a_r = side_slip(x, ctrl[t + 1])
        mu_f, mu_r = mu_y_true(a_f), mu_y_true(a_r)
        y = observe(x, ctrl[t + 1], mu_f, mu_r) + noise[t, 1] * r_std
        states.append(x)
        obs.append(y)
        mus_f.append(mu_f)
        mus_r.append(mu_r)
    out = (torch.stack(states), torch.stack(obs), torch.stack(mus_f),
           torch.stack(mus_r), ctrl)
    return tuple(o.to(device) for o in out)
