"""Single-mass oscillator: mass-spring-damper with an unknown restoring
force (port of ``bipk_tpu/models/oscillator.py``).

Learns the scalar spring/damper force ``F_sd(x, dx)`` (cubic spring plus
a nonlinear damper; one GP node, 41 Hilbert basis functions on
``[-7.5, 7.5]^2`` over the state) inside a known rigid-body skeleton
integrated with RK4. The measurement is the position. The physics takes
batch-last states ``(2, N)`` and forces ``(N,)``, or one state ``(2,)``
and scalars.
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

MASS = 0.2
C1, C2 = 5.0, 2.0
D1, D2 = 0.4, 0.4


def spring_force(x):
    return C1 * x + C2 * x**3


def damper_force(dx):
    return D1 * dx / (1.0 + D2 * dx * torch.tanh(dx))


def _rhs(x, force_ext, force_sd):
    return torch.stack([x[1], (force_ext - force_sd) / MASS])


def transition(x, force_ext, force_sd, dt):
    """RK4 step of the mass-spring-damper skeleton."""
    return rk4_step(_rhs, x, dt, force_ext, force_sd)


@dataclasses.dataclass(frozen=True)
class OscillatorConfig:
    n_basis: int = 41
    domain: float = 7.5
    magnitude: float = 100.0
    prior_df: float = 3.0
    n_particles: int = 200
    n_gibbs: int = 800
    forgetting_factor: float = 0.999
    dt: float = 0.02
    t_end: float = 15.0
    seed: int = 12345678

    @property
    def lengthscale(self) -> float:
        return self.domain * 2.0 / self.n_basis

    @property
    def n_steps(self) -> int:
        return len(np.arange(0.0, self.t_end, self.dt))


# process, measurement and initial-force noise, as the JAX model
R = np.array([[1e-3]])
Q = np.diag([5e-8, 5e-9])
P0_F = np.diag([1e-12])


@dataclasses.dataclass(frozen=True)
class OscillatorModel:
    config: OscillatorConfig
    ssm: SSM
    gp: GPNode
    basis: basis_ops.HilbertBasis
    x0: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((2,)))
    p0: np.ndarray = dataclasses.field(
        default_factory=lambda: np.diag([1e-4, 1e-4])
    )

    @property
    def gps(self) -> tuple:
        return (self.gp,)


def external_force(config: OscillatorConfig) -> np.ndarray:
    """Piecewise gravity-step input ``(T, 1)``."""
    force = np.ones((config.n_steps, 1)) * 9.81 * MASS
    force[int(config.t_end / (3 * config.dt)):] = 0.0
    force[int(2 * config.t_end / (3 * config.dt)):] = -9.81 * MASS
    return force


def model_from_parts(
    config: OscillatorConfig, hb: basis_ops.HilbertBasis, prior,
    process_noise=Q, output_noise=R, init_cov=P0_F, **initial,
) -> OscillatorModel:
    """Assemble the oscillator model from its basis and GP prior."""
    dt = config.dt
    ssm = SSM(
        transition=lambda state, inp, *iv: transition(state, inp[0], iv[0][0], dt),
        output=lambda state, inp, *iv: state[0],
        process_noise=np.asarray(process_noise),
        output_noise=np.asarray(output_noise),
    )
    gp = GPNode(
        basis_fn_bl=lambda state, inp: hb.eigen_fn_bl(state),
        prior=prior, init_mean=np.zeros(1), init_cov=np.asarray(init_cov),
    )
    return OscillatorModel(config=config, ssm=ssm, gp=gp, basis=hb, **initial)


def make_model(config: OscillatorConfig = OscillatorConfig()) -> OscillatorModel:
    hb = basis_ops.make_hilbert_basis(
        config.n_basis,
        np.array([[-config.domain, config.domain]] * 2),
        config.lengthscale,
        config.magnitude,
    )
    prior = natural_from_standard(
        np.zeros((1, config.n_basis)), np.diag(hb.spectral_density),
        np.eye(1), config.prior_df,
    )
    return model_from_parts(config, hb, prior)


def simulate(
    generator: torch.Generator, config: OscillatorConfig = OscillatorConfig(),
    dtype=torch.float32, device="cuda",
):
    """Synthetic data from the true spring and damper forces.

    Draws the process and measurement noise from ``generator`` (a CPU
    generator) in a loop of its own, integrates on the CPU and returns, on
    ``device`` (CUDA unless the caller asks for the CPU), ``(states (T, 2),
    observations (T, 1), true_force (T, 1), inputs (T, 1))`` with
    ``observations[0] = 0`` and ``true_force[t]`` the force at
    ``states[t]`` (0 at the last step), as the JAX ``simulate``.
    """
    device = resolve_device(device)
    T = config.n_steps
    force = torch.as_tensor(external_force(config), dtype=dtype)
    chol_q = torch.as_tensor(np.linalg.cholesky(Q), dtype=dtype)
    r_std = float(np.sqrt(R[0, 0]))
    noise = torch.randn((T - 1, 3), generator=generator, dtype=dtype)
    x = torch.zeros(2, dtype=dtype)
    states, obs, f_sds = [x], [torch.zeros((), dtype=dtype)], []
    for t in range(T - 1):
        f_sd = spring_force(x[0]) + damper_force(x[1])
        x = transition(x, force[t, 0], f_sd, config.dt) + chol_q @ noise[t, :2]
        states.append(x)
        obs.append(x[0] + noise[t, 2] * r_std)
        f_sds.append(f_sd)
    f_sds.append(torch.zeros((), dtype=dtype))
    out = (torch.stack(states), torch.stack(obs)[:, None],
           torch.stack(f_sds)[:, None], force)
    return tuple(o.to(device) for o in out)
