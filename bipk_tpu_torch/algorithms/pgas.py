"""Classic particle Gibbs with ancestor sampling and explicit parameter
draws (port of ``bipk_tpu/algorithms/pgas.py``: ``PGASResult``,
``build_pgas_csmc`` and ``build_pgas``).

The baseline sampler: the transition is purely the basis-expansion GP
``x_t ~ N(A phi(x_{t-1}, u_t), S)`` (no physics skeleton), and the Gibbs
sweep alternates a conditional SMC trajectory draw with a conjugate MNIW
parameter draw (inverse Wishart by Bartlett plus matrix normal,
:func:`~bipk_tpu_torch.ops.mniw.sample_parameters`). As in the JAX
package, the cSMC propagates with the input at the *current* step while
the parameter update pairs ``(x_{t-1}, u_{t-1}) -> x_t``.

Two deliberate departures from the reference implementation, as in the
JAX package (both verified against an exact Kalman/RTS smoother,
``tests/test_torch_pgas.py``):

1. the proposal starts from the *resampled* ancestors (the reference
   proposes from the pre-resampling states, breaking the ancestral
   linkage its own backward reconstruction assumes);
2. the pinned particle's ancestor-sampling weight is ``w_{t-1} f(ref_t |
   x_{t-1})``, without the look-ahead factor (which cancels against the
   pinned particle's ``1/nu`` weight correction; keeping it breaks the
   cSMC's invariance).

The callables are batch-last, as ``SSM`` and ``GPNode``'s are
(:mod:`bipk_tpu_torch.models.ssm`): ``basis_fn(x (dx, N), u) -> phi (m,
N)`` and ``likelihood_fn(obs, x (dx, N), u) -> (N,)``, where ``u`` is
``(du,)`` for every column or ``(du, N)`` and ``obs`` ``(dy,)`` or ``(dy,
N)``, one per column. Every random number is an input (:class:`PGASDraws`,
:class:`~bipk_tpu_torch.ops.mniw.ParameterDraws`), so the tests can feed
the JAX package's draws; a step keeps every value on the device.
Resampling is the systematic kernel (``cuda_kernels.
systematic_ancestors_blocks``, float32 on the card), or its plain version
with ``reference=True``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from bipk_tpu_torch._device import resolve_device
from bipk_tpu_torch.algorithms.apf import as_tensor
from bipk_tpu_torch.ops import cuda_kernels as ck
from bipk_tpu_torch.ops import mniw, resampling
from bipk_tpu_torch.ops.gaussian import mvn_logpdf_chol, mvn_sample_chol


class PGASResult(NamedTuple):
    """The JAX ``PGASResult``'s fields and layouts."""

    states: torch.Tensor  # (T, K, dx)
    log_likelihood: torch.Tensor  # (T, K)
    coeffs: torch.Tensor  # (K, dx, m) sampled coefficient matrices
    covs: torch.Tensor  # (K, dx, dx) sampled noise covariances


class PGASDraws(NamedTuple):
    """The random numbers one cSMC sweep of ``T`` steps consumes."""

    z0: torch.Tensor  # (dx, N) standard normals of the initial states
    u_res: torch.Tensor  # (T-1,) systematic-resampling offsets
    u_ref: torch.Tensor  # (T-1,) uniforms of the reference's ancestor
    u_final: torch.Tensor  # (1,) uniform of the returned trajectory's index
    z: torch.Tensor  # (T-1, dx, N) process-noise normals


class PGASCSMC:
    """The fixed-parameter conditional SMC sweep inside PGAS. Call it as
    ``sweep(generator, observations, inputs, init_mean, init_cov,
    ref_state, A, S) -> trajectory (T, dx)``; :meth:`draws` and
    :meth:`run` split the draws from the sweep."""

    def __init__(self, basis_fn: Callable, likelihood_fn: Callable, n_particles: int,
                 dtype, device, reference: bool = False):
        self.basis_fn = basis_fn
        self.likelihood_fn = likelihood_fn
        self.n_particles = n_particles
        self.dtype = dtype
        self.device = torch.device(device)
        self._systematic = (ck.PLAIN[ck.systematic_ancestors_blocks] if reference
                            else ck.systematic_ancestors_blocks)

    def draws(self, generator: torch.Generator, n_steps: int, state_dim: int) -> PGASDraws:
        """A sweep's draws from ``generator``, each kind in one call."""
        opts = dict(generator=generator, dtype=self.dtype, device=self.device)
        N = self.n_particles
        return PGASDraws(
            torch.randn((state_dim, N), **opts),
            torch.rand((n_steps - 1,), **opts),
            torch.rand((n_steps - 1,), **opts),
            torch.rand((1,), **opts),
            torch.randn((n_steps - 1, state_dim, N), **opts),
        )

    def step(self, carry, obs, inp, ref_x, A, chol_S, log_det_S, u_res, u_ref, z):
        """One step from ``carry = (log_weights (N,), state (dx, N))``;
        returns ``(carry, ancestors)``, the reference's ancestor patched
        into the last slot."""
        log_weights, state = carry
        aux_state = A @ self.basis_fn(state, inp)
        ll_aux = self.likelihood_fn(obs, aux_state, inp)
        ancestors = self._systematic(torch.softmax(ll_aux + log_weights, 0), u_res,
                                     self.n_particles).clone()
        # the pinned particle's ancestor: the valid AS weight
        # w_{t-1} f(ref_t | x_{t-1}) (departure 2, module docstring)
        h_x = mvn_logpdf_chol(ref_x[:, None], aux_state, chol_S, log_det_chol=log_det_S)
        ref_idx = resampling.categorical_from_weights(torch.softmax(log_weights + h_x, 0),
                                                      u_ref)
        ancestors[-1:] = ref_idx.view(1)
        # propose from the resampled ancestors (departure 1)
        new_state = aux_state.index_select(1, ancestors) + chol_S @ z
        new_state[:, -1] = ref_x
        new_log_weights = (self.likelihood_fn(obs, new_state, inp)
                           - ll_aux.index_select(0, ancestors))
        return (new_log_weights, new_state), ancestors

    def run(self, draws: PGASDraws, observations, inputs, init_mean, init_cov, ref_state,
            A, S) -> torch.Tensor:
        """The sweep with the given draws; returns the drawn trajectory
        ``(T, dx)``."""
        obs = as_tensor(observations, self.dtype, self.device)
        obs = obs.reshape(obs.shape[0], -1)
        inputs = as_tensor(inputs, self.dtype, self.device)
        ref = as_tensor(ref_state, self.dtype, self.device)
        ref = ref.reshape(ref.shape[0], -1)
        A = as_tensor(A, self.dtype, self.device)
        chol_S = mniw.chol_spd(as_tensor(S, self.dtype, self.device))
        log_det_S = torch.log(torch.diagonal(chol_S)).sum()
        # the initial states as jax.random.multivariate_normal draws them:
        # an unjittered Cholesky factor of init_cov
        chol0 = torch.linalg.cholesky_ex(
            as_tensor(np.atleast_2d(init_cov), self.dtype, self.device))[0]
        state = mvn_sample_chol(as_tensor(init_mean, self.dtype, self.device), chol0, draws.z0)
        state[:, -1] = ref[0]
        carry = (torch.zeros((self.n_particles,), dtype=self.dtype, device=self.device), state)
        states, ancestors = [state], []
        for t in range(obs.shape[0] - 1):
            carry, anc = self.step(carry, obs[t + 1], inputs[t + 1], ref[t + 1], A, chol_S,
                                   log_det_S, draws.u_res[t], draws.u_ref[t], draws.z[t])
            states.append(carry[1])
            ancestors.append(anc)
        idx = resampling.categorical_from_weights(torch.softmax(carry[0], 0), draws.u_final)
        traj, _ = resampling.reconstruct_trajectory_bl(torch.stack(states),
                                                       torch.stack(ancestors), idx)
        return traj

    def __call__(self, generator, observations, inputs, init_mean, init_cov, ref_state,
                 A, S) -> torch.Tensor:
        ref = torch.atleast_2d(as_tensor(ref_state, self.dtype, self.device).T).T
        draws = self.draws(generator, ref.shape[0], ref.shape[1])
        return self.run(draws, observations, inputs, init_mean, init_cov, ref, A, S)


def build_pgas_csmc(
    basis_fn: Callable,
    likelihood_fn: Callable,
    n_particles: int,
    dtype=torch.float32,
    device: str | torch.device = "cuda",
    reference: bool = False,
) -> PGASCSMC:
    """Build the fixed-parameter conditional SMC sweep used inside PGAS
    (:class:`PGASCSMC`), exposed on its own so that its invariance can be
    held against exact Kalman/RTS posteriors on linear-Gaussian models.
    ``device`` defaults to CUDA and raises if no card is present;
    ``reference=True`` resamples with the kernel's plain version."""
    device = resolve_device(device)
    return PGASCSMC(basis_fn, likelihood_fn, n_particles, dtype, device, reference)


class PGAS:
    """The classic PGAS sampler. Call it as ``pgas(generator, observations,
    inputs, init_state_mean, init_state_cov, init_ref_state,
    callback=None) -> PGASResult``; ``callback(k, (ref, A, S))`` runs after
    sweep ``k``."""

    def __init__(self, csmc: PGASCSMC, prior: mniw.MNIW, n_iterations: int):
        self.csmc = csmc
        self.n_iterations = n_iterations
        self.prior = mniw.MNIW(*(
            torch.as_tensor(np.array(p, np.float64), dtype=csmc.dtype, device=csmc.device)
            for p in prior
        ))

    def posterior(self, trajectory, inputs) -> mniw.MNIW:
        """The prior plus the trajectory's summed statistics, pairing
        ``(x_{t-1}, u_{t-1}) -> x_t``; the basis takes one input column
        per time point."""
        phi = self.csmc.basis_fn(trajectory[:-1].T, inputs[:-1].T)
        y = trajectory[1:].T
        p = self.prior
        return mniw.MNIW(p.T0 + phi @ y.T, p.T1 + phi @ phi.T, p.T2 + y @ y.T,
                         p.T3 + float(y.shape[1]))

    def draws(self, generator: torch.Generator, n_steps: int, state_dim: int):
        """The run's draws from ``generator``, one pair per iteration,
        drawn as they are consumed: ``(None, ParameterDraws)`` for the
        initial reference, then ``(PGASDraws, ParameterDraws)`` per sweep.
        The posterior's degrees of freedom (the prior's plus ``T - 1``)
        are the same at every iteration."""
        c = self.csmc
        df = self.prior.T3 + float(n_steps - 1)
        m = self.prior.T1.shape[0]
        yield None, mniw.parameter_draws(generator, df, state_dim, m)
        for _ in range(1, self.n_iterations):
            yield (c.draws(generator, n_steps, state_dim),
                   mniw.parameter_draws(generator, df, state_dim, m))

    def run(self, draws, observations, inputs, init_state_mean, init_state_cov,
            init_ref_state, callback: Callable | None = None) -> PGASResult:
        """The sampler with the given draws: an iterable of
        ``n_iterations`` pairs as :meth:`draws` gives them."""
        c = self.csmc
        obs = as_tensor(observations, c.dtype, c.device)
        obs = obs.reshape(obs.shape[0], -1)
        inputs = as_tensor(inputs, c.dtype, c.device)
        ref = torch.atleast_2d(as_tensor(init_ref_state, c.dtype, c.device).T).T
        T, dx = ref.shape
        refs, As, Ss = [], [], []
        for k, (sweep_draws, param_draws) in enumerate(draws):
            if k:
                ref = c.run(sweep_draws, obs, inputs, init_state_mean, init_state_cov, ref,
                            As[-1], Ss[-1])
            # the conjugate (A, S) draw given the trajectory
            A, S = mniw.sample_parameters(self.posterior(ref, inputs), param_draws)
            refs.append(ref)
            As.append(A)
            Ss.append(S)
            if k and callback is not None:
                callback(k, (ref, A, S))
        states = torch.stack(refs, 1)  # (T, K, dx)
        K = states.shape[1]
        log_lik = c.likelihood_fn(obs.repeat_interleave(K, 0).T, states.reshape(T * K, dx).T,
                                  inputs.repeat_interleave(K, 0).T)
        return PGASResult(states, log_lik.reshape(T, K), torch.stack(As), torch.stack(Ss))

    def __call__(self, generator, observations, inputs, init_state_mean, init_state_cov,
                 init_ref_state, callback: Callable | None = None) -> PGASResult:
        ref = torch.atleast_2d(as_tensor(init_ref_state, self.csmc.dtype, self.csmc.device).T).T
        return self.run(self.draws(generator, *ref.shape), observations, inputs,
                        init_state_mean, init_state_cov, ref, callback)


def build_pgas(
    basis_fn: Callable,
    likelihood_fn: Callable,
    prior: mniw.MNIW,
    n_particles: int,
    n_iterations: int,
    dtype=torch.float32,
    fused: bool = True,
    device: str | torch.device = "cuda",
    reference: bool = False,
) -> PGAS:
    """Build the classic PGAS sampler (:class:`PGAS`): ``prior`` the MNIW
    prior over ``(A, S)`` in natural form (numpy leaves). ``n_iterations``
    counts the initial reference's parameter draw, as in the JAX package:
    the sampler runs ``n_iterations - 1`` sweeps. ``fused`` is accepted for
    the JAX signature; both values run the same host loop. ``device``
    defaults to CUDA and raises if no card is present; ``reference=True``
    resamples with the kernel's plain version."""
    del fused
    return PGAS(build_pgas_csmc(basis_fn, likelihood_fn, n_particles, dtype, device, reference),
                prior, n_iterations)
