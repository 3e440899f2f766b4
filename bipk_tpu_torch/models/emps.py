"""EMPS: the electro-mechanical positioning system (port of
``bipk_tpu/models/emps.py``).

Rigid-body model ``q'' = (tau - F)/M`` with an unknown friction ``F(q')``
(one GP node, 9 Hilbert basis functions on the velocity) learned from
measured joint positions, integrated with RK4; a classic-PGAS baseline
learns the *full* two-dimensional transition with a 729-function basis
over the normalized ``(q, q', tau)``.

The benchmark files ``DATA_EMPS.mat`` / ``DATA_EMPS_PULSES.mat`` are not
in the repository: :func:`load_dataset` reads them from ``data_dir`` when
present and otherwise synthesizes surrogate measurements from the
published linear model, on the host in float64 numpy (a plain loop where
the JAX package scans), with the same preprocessing (Butterworth filtering,
central differences, x10 decimation), so both packages compute the same
data. The physics takes batch-last states ``(2, N)`` with torques and
frictions ``(N,)`` or scalars.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from bipk_tpu_torch.models.ssm import GPNode, SSM
from bipk_tpu_torch.ops import basis as basis_ops
from bipk_tpu_torch.ops.integrators import rk4_step
from bipk_tpu_torch.ops.mniw import MNIW, natural_from_standard

MASS = 95.11

# measurement, process, initial-state and initial-friction noise, as the
# JAX model
R = np.diag([1e-4])
Q = np.diag([1e-6, 1e-7])
P0 = np.diag([1e-5, 1e-6])
P0_F = np.diag([1e-12])

# the baseline basis' input normalisation of (q, q', tau)
BASELINE_SCALE = (0.4, 0.4, 160.0)


def _rhs(x, tau, friction):
    return torch.stack([x[1], (tau - friction) / MASS])


def transition(x, tau, friction, dt):
    """RK4 step of the rigid body with friction ``friction``."""
    return rk4_step(_rhs, x, dt, tau, friction)


def _backend(x):
    return (torch.stack, torch.sign) if isinstance(x, torch.Tensor) else (np.stack, np.sign)


def linear_friction(dq):
    """The published linear benchmark model's friction ``203.5 dq + 20.39
    sign(dq) - 3.16``; a tensor or a numpy array."""
    return 203.5 * dq + 20.39 * _backend(dq)[1](dq) - 3.16


def _linear_rhs(x, tau):
    stack, sign = _backend(x)
    return stack([x[1], (tau - 203.5 * x[1] - 20.39 * sign(x[1]) + 3.16) / MASS])


def linear_transition(x, tau, dt):
    """RK4 step of the published linear benchmark model; a tensor or a
    numpy array (the surrogate data integrate it on the host)."""
    return rk4_step(_linear_rhs, x, dt, tau)


class EMPSData(NamedTuple):
    time: np.ndarray  # (T,)
    states: np.ndarray  # (T, 2) filtered position + derived velocity
    observations: np.ndarray  # (T, 1) measured position
    inputs: np.ndarray  # (T, 1) motor torque
    dt: float
    synthetic: bool


def central_difference(x: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Central-difference derivative with one-sided ends."""
    dxdt = np.zeros_like(x)
    dxdt[0] = (x[1] - x[0]) / (t[1] - t[0])
    dxdt[1:-1] = (x[2:] - x[:-2]) / (t[2:] - t[:-2])
    dxdt[-1] = (x[-1] - x[-2]) / (t[-1] - t[-2])
    return dxdt


def _preprocess(q_measured, t, torque, decimation=10):
    """Low-pass the position (4th-order Butterworth at 100 Hz on a 500 Hz
    Nyquist, forward and backward), differentiate, decimate."""
    import scipy.signal

    sos = scipy.signal.butter(4, 100 / 500, btype="lowpass", output="sos")
    q_filt = scipy.signal.sosfiltfilt(sos, q_measured)
    dq = central_difference(q_filt, t)
    states = np.vstack([q_filt, dq]).T[0:-1:decimation]
    time = t[0:-1:decimation]
    obs = q_measured[0:-1:decimation][:, None]
    inputs = torque[0:-1:decimation][:, None]
    return time, states, obs, inputs


def synthesize_measurements(seed: int = 0, n_raw: int = 24_000, dt_raw: float = 0.001):
    """Surrogate raw measurements from the published linear model.

    A band-limited random torque excites the linear EMPS model at 1 kHz;
    the 'measured' position adds encoder-scale noise. Stands in for the
    absent ``DATA_EMPS.mat``. Returns ``(t, q, torque)``, numpy float64."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_raw) * dt_raw
    # smooth random torque: low-pass filtered white noise, amplitude ~100
    raw = rng.standard_normal(n_raw)
    kernel = np.exp(-0.5 * (np.linspace(-3, 3, 501)) ** 2)
    torque = 120.0 * np.convolve(raw, kernel / kernel.sum(), mode="same")
    torque = torque / max(1e-9, np.abs(torque).max()) * 120.0
    xs = np.zeros((n_raw, 2))
    for i, tau in enumerate(torque[:-1].tolist()):
        xs[i + 1] = linear_transition(xs[i], tau, dt_raw)
    qs = xs[:, 0] + rng.standard_normal(n_raw) * 1e-5
    return t, qs, torque


def load_dataset(data_dir: str | None = None, kind: str = "train", seed: int = 0) -> EMPSData:
    """Real EMPS measurements if ``data_dir`` holds them, else surrogate
    ones. ``kind`` is ``"train"`` (``DATA_EMPS.mat``) or ``"pulses"``
    (``DATA_EMPS_PULSES.mat``, the validation set; seed + 1)."""
    fname = "DATA_EMPS.mat" if kind == "train" else "DATA_EMPS_PULSES.mat"
    path = os.path.join(data_dir, fname) if data_dir else None
    if path and os.path.exists(path):
        import scipy.io

        data = scipy.io.loadmat(path)
        t = data["t"].flatten()
        q = data["qm"].flatten()
        torque = (data["vir"] * data["gtau"]).flatten()
        synthetic = False
    else:
        t, q, torque = synthesize_measurements(seed=seed if kind == "train" else seed + 1)
        synthetic = True
    time, states, obs, inputs = _preprocess(q, t, torque)
    return EMPSData(time=time, states=states, observations=obs, inputs=inputs,
                    dt=float(time[1] - time[0]), synthetic=synthetic)


@dataclasses.dataclass(frozen=True)
class EMPSConfig:
    n_basis: int = 9
    velocity_domain: float = 0.2
    magnitude: float = 20.0
    prior_df: float = 2.0
    prior_row_scale: float = 4.0
    n_particles: int = 200
    n_gibbs: int = 800
    forgetting_factor: float = 0.999
    baseline_magnitude: float = 20.0
    seed: int = 12345678

    @property
    def lengthscale(self) -> float:
        return 2 * self.velocity_domain / self.n_basis

    @property
    def n_basis_baseline(self) -> int:
        return self.n_basis**3


@dataclasses.dataclass(frozen=True)
class EMPSModel:
    config: EMPSConfig
    data: EMPSData
    ssm: SSM
    gp: GPNode
    basis: basis_ops.HilbertBasis
    baseline_basis: basis_ops.HilbertBasis
    baseline_prior: MNIW

    @property
    def gps(self) -> tuple:
        return (self.gp,)

    @property
    def x0(self) -> np.ndarray:
        return np.array([float(self.data.observations[0, 0]), 0.0])

    @property
    def p0(self) -> np.ndarray:
        return P0

    def baseline_basis_fn(self, state, inp):
        """The classic-PGAS baseline's basis over the normalized ``(q, q',
        tau)``, batch-last: ``state (2, N)``, ``inp (1,)`` or ``(1, N)`` ->
        ``(729, N)``."""
        tau = inp[:1].reshape(1, -1).expand(1, state.shape[-1])
        # Python-float scales: a tensor made from them would be a host-to-device
        # copy, and a host synchronisation, at every call
        q_scale, dq_scale, tau_scale = BASELINE_SCALE
        z = torch.cat([state[:1] / q_scale, state[1:2] / dq_scale, tau / tau_scale], 0)
        return self.baseline_basis.eigen_fn_bl(z)


def model_from_parts(config: EMPSConfig, data: EMPSData, hb, prior, hb_base, baseline_prior,
                     process_noise=Q, output_noise=R, init_cov=P0_F) -> EMPSModel:
    """Assemble the EMPS model from its data, bases and priors."""
    dt = data.dt
    ssm = SSM(
        transition=lambda state, inp, *iv: transition(state, inp[0], iv[0][0], dt),
        output=lambda state, inp, *iv: state[0],
        process_noise=np.asarray(process_noise),
        output_noise=np.asarray(output_noise),
    )
    gp = GPNode(
        basis_fn_bl=lambda state, inp: hb.eigen_fn_bl(state[1]),
        prior=prior, init_mean=np.zeros(1), init_cov=np.asarray(init_cov),
    )
    return EMPSModel(config=config, data=data, ssm=ssm, gp=gp, basis=hb,
                     baseline_basis=hb_base, baseline_prior=baseline_prior)


def make_model(config: EMPSConfig = EMPSConfig(), data: EMPSData | None = None,
               data_dir: str | None = "data") -> EMPSModel:
    if data is None:
        data = load_dataset(data_dir=data_dir, kind="train")
    hb = basis_ops.make_hilbert_basis(
        config.n_basis, np.array([-config.velocity_domain, config.velocity_domain]),
        config.lengthscale, config.magnitude,
    )
    prior = natural_from_standard(
        np.zeros((1, config.n_basis)), np.diag(hb.spectral_density),
        np.eye(1) * config.prior_row_scale, config.prior_df,
    )
    n_base = config.n_basis_baseline
    hb_base = basis_ops.make_hilbert_basis(
        n_base, np.array([[-1.0, 1.0]] * 3), 0.5 / n_base, config.baseline_magnitude,
    )
    baseline_prior = natural_from_standard(
        np.zeros((2, n_base)), np.diag(hb_base.spectral_density), np.eye(2), 2.0,
    )
    return model_from_parts(config, data, hb, prior, hb_base, baseline_prior)


def validation_rmse(model: EMPSModel, gp_mean_alg2, gp_mean_pgas=None,
                    data: EMPSData | None = None):
    """Roll the identified models forward on the validation pulses: the
    position RMSE of the Algorithm-2 model (the friction GP's mean ``(1,
    9)``) and, given ``gp_mean_pgas (2, 729)``, of the classic-PGAS
    full-transition model (else None). A sequential recursion of scalars,
    so it runs on the host in float64 whatever the means' device."""
    if data is None:
        data = load_dataset(data_dir=None, kind="pulses")
    f64 = dict(dtype=torch.float64, device="cpu")
    dt = data.dt
    obs = torch.as_tensor(data.observations[:, 0], **f64)
    tau = torch.as_tensor(data.inputs[:, 0], **f64)
    x0 = torch.stack([obs[0], torch.zeros((), **f64)])

    def rollout(step):
        x, qs = x0, [x0[0]]
        for t in range(tau.shape[0] - 1):
            x = step(x, tau[t])
            qs.append(x[0])
        return math.sqrt(float(((torch.stack(qs) - obs) ** 2).mean()))

    w_alg2 = torch.as_tensor(gp_mean_alg2, **f64)[0]
    rmse_alg2 = rollout(lambda x, tau_t: transition(
        x, tau_t, w_alg2 @ model.basis.eigen_fn_bl(x[1:2])[:, 0], dt))
    if gp_mean_pgas is None:
        return rmse_alg2, None
    w_pgas = torch.as_tensor(gp_mean_pgas, **f64)
    rmse_pgas = rollout(lambda x, tau_t: (w_pgas @ model.baseline_basis_fn(
        x[:, None], tau_t.reshape(1)))[:, 0])
    return rmse_alg2, rmse_pgas
