"""Toy example: 1-D blind system identification (port of
``bipk_tpu/models/toy.py``).

True dynamics ``x_t = 10 sinc(x_{t-1}/7) + w`` with an identity output.
The transition used for inference is the interface variable alone (no
physics): one GP node, 40 Hilbert basis functions on [-30, 30], MNIW prior
df 10, no process noise, and no inputs (``(T, 0)``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bipk_tpu_torch._device import resolve_device
from bipk_tpu_torch.models.ssm import GPNode, SSM
from bipk_tpu_torch.ops import basis as basis_ops
from bipk_tpu_torch.ops.mniw import natural_from_standard


def f_true(x):
    """True unknown sub-function ``10 sinc(x/7)`` (normalized sinc); a
    tensor or a numpy array."""
    if isinstance(x, torch.Tensor):
        return 10.0 * torch.sinc(x / 7.0)
    return 10.0 * np.sinc(np.asarray(x) / 7.0)


@dataclasses.dataclass(frozen=True)
class ToyConfig:
    n_basis: int = 40
    domain: float = 30.0
    lengthscale: float = 3.0
    magnitude: float = 50.0
    prior_df: float = 10.0
    n_particles: int = 200
    n_gibbs: int = 200
    forgetting_factor: float = 1.0
    n_steps: int = 40
    obs_noise: float = 4.0
    sim_noise: float = 4.0
    init_state_cov: float = 1e-4
    seed: int = 12345678


@dataclasses.dataclass(frozen=True)
class ToyModel:
    config: ToyConfig
    ssm: SSM
    gp: GPNode
    basis: basis_ops.HilbertBasis

    @property
    def gps(self) -> tuple:
        return (self.gp,)

    @property
    def x0(self) -> np.ndarray:
        return np.zeros((1,))

    @property
    def p0(self) -> np.ndarray:
        return np.diag([self.config.init_state_cov])


def model_from_parts(
    config: ToyConfig, hb: basis_ops.HilbertBasis, prior,
    output_noise=None, init_mean=None, init_cov=None,
) -> ToyModel:
    """Assemble the toy model from its basis and GP prior; the noises and
    the interface variable's initial law default to ``config``'s."""
    ssm = SSM(
        transition=lambda state, inp, *iv: iv[0],
        output=lambda state, inp, *iv: iv[0],
        process_noise=np.zeros((1, 1)),
        output_noise=np.diag([config.obs_noise]) if output_noise is None
        else np.asarray(output_noise),
    )
    gp = GPNode(
        basis_fn_bl=lambda state, inp: hb.eigen_fn_bl(state),
        prior=prior,
        init_mean=f_true(np.zeros(1)) if init_mean is None else np.asarray(init_mean),
        init_cov=np.diag([config.sim_noise]) if init_cov is None else np.asarray(init_cov),
    )
    return ToyModel(config=config, ssm=ssm, gp=gp, basis=hb)


def make_model(config: ToyConfig = ToyConfig()) -> ToyModel:
    hb = basis_ops.make_hilbert_basis(
        config.n_basis, np.array([-config.domain, config.domain]),
        config.lengthscale, config.magnitude,
    )
    prior = natural_from_standard(
        np.zeros((1, config.n_basis)), np.diag(hb.spectral_density),
        np.eye(1), config.prior_df,
    )
    return model_from_parts(config, hb, prior)


def simulate(
    generator: torch.Generator, config: ToyConfig = ToyConfig(),
    dtype=torch.float32, device="cuda",
):
    """Synthetic data: ``x_{t+1} = f_true(x_t) + sqrt(sim_noise) w``,
    ``y = x + sqrt(obs_noise) v``, ``x_0 = 0``.

    Draws the noise from ``generator`` (a CPU generator) and returns, on
    ``device`` (CUDA unless the caller asks for the CPU), ``(states (T,
    1), observations (T, 1))`` with ``observations[0] = 0``, as the JAX
    ``simulate``. The model has no inputs: pass ``(T, 0)`` ones."""
    device = resolve_device(device)
    q, r = float(np.sqrt(config.sim_noise)), float(np.sqrt(config.obs_noise))
    noise = torch.randn((config.n_steps - 1, 2), generator=generator, dtype=dtype)
    x = torch.zeros((1,), dtype=dtype)
    states, obs = [x], [torch.zeros((1,), dtype=dtype)]
    for t in range(config.n_steps - 1):
        x = f_true(x) + noise[t, :1] * q
        states.append(x)
        obs.append(x + noise[t, 1:] * r)
    return torch.stack(states).to(device), torch.stack(obs).to(device)
