"""The online APF sweep on one device (port of the single-device, local-
scheme body of ``bipk_tpu/parallel/sharded.py`` ``build_sharded_apf``).

Per step: the auxiliary look-ahead (one factorize+project kernel per GP,
which with ``reuse_factor`` also emits the factor), systematic resampling
on the first-stage weights (one kernel), a gather of the small
per-particle payloads and the RK4 propagation, the fused
resampling-gather + matrix-t draw + rank-1 statistics update (one kernel
per GP: the gather/draw, the factor-reusing or the dedup kernel), the
log-likelihood, and the weighted moments. Traces reduce to
weighted moments on the fly, as in the JAX package.

This slice ports one device and the local scheme only; more devices, the
exact scheme, and the chunked and windowed modes raise.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from bipk_tpu_torch._device import resolve_device
from bipk_tpu_torch.algorithms.apf import APF, APFKernel, StepDraws, as_tensor
from bipk_tpu_torch.models.ssm import GPNode, SSM
from bipk_tpu_torch.ops import mniw


class ShardedAPFResult(NamedTuple):
    state_mean: torch.Tensor  # (T, dx) weighted posterior mean
    int_var_mean: tuple  # each (T, n_i)
    stats_mean: tuple  # each MNIW with leading (T, ...)
    ess: torch.Tensor  # (T,)
    final_state: torch.Tensor  # (N, dx)
    final_log_weights: torch.Tensor  # (N,)
    final_stats: tuple  # each MNIW batch-last (..., N)


class ShardedAPF:
    """The single-device online APF sweep, reducing its traces to weighted
    moments on the fly. Call it as ``apf(generator, observations, inputs,
    init_state_mean, init_state_cov)``; :meth:`init`, :meth:`draws` and
    :meth:`step` expose one step with injected draws."""

    def __init__(self, kern: APFKernel, n_particles: int, forgetting_factor: float):
        self.kern = kern
        self.n_particles = n_particles
        self.lam = forgetting_factor
        self._filter = APF(kern, n_particles, forgetting_factor)

    def draws(self, generator: torch.Generator) -> StepDraws:
        return self.kern.step_draws(generator, self.n_particles)

    def init(self, generator, inputs0, init_mean, init_cov):
        """Initial carry ``(log_weights, state, int_vars, Ss)``."""
        return self._filter.init(generator, inputs0, init_mean, init_cov)

    def moments(self, w, state, int_vars, Ss):
        """Weighted moments ``(state_mean, int_var_means, reduced packed
        statistics per GP, ess)``."""
        return (
            state @ w,
            tuple(iv @ w for iv in int_vars),
            self.kern.weighted_stats_packed(Ss, w),
            1.0 / (w * w).sum(),
        )

    def step(self, carry, obs, inp_prev, inp_cur, draws: StepDraws):
        """One filter step (:meth:`APF.step`); returns ``(carry,
        moments)``. With one shard the local scheme's shard mass is the
        global softmax's sum, 1 up to rounding: the systematic kernel
        takes unnormalized weights, and the log-weight offset log(mass)
        shifts every weight alike, so neither is applied."""
        carry, _ = self._filter.step(carry, obs, inp_prev, inp_cur, draws)
        return carry, self.moments(torch.softmax(carry[0], 0), *carry[1:])

    def finish(self, moments: list, carry) -> ShardedAPFResult:
        """Stack per-step moments and unpack the final statistics."""
        kern = self.kern
        sm, ivm, red, ess = zip(*moments)
        stats_mean = tuple(
            mniw.unpack_reduced(torch.stack([r[i] for r in red]), kern.ms[i], kern.ns[i])
            for i in range(kern.n_gp)
        )
        final_log_w, final_state, _, final_Ss = carry
        final_stats = tuple(
            mniw.from_flat_bl(mniw.unpack_stats_bl(S, kern.ms[i], kern.ns[i]),
                              kern.ms[i], kern.ns[i])
            for i, S in enumerate(final_Ss)
        )
        return ShardedAPFResult(
            torch.stack(sm),
            tuple(torch.stack([v[i] for v in ivm]) for i in range(kern.n_gp)),
            stats_mean,
            torch.stack(ess),
            final_state.T,
            final_log_w,
            final_stats,
        )

    def __call__(
        self, generator: torch.Generator, observations, inputs,
        init_state_mean, init_state_cov,
    ) -> ShardedAPFResult:
        k = self.kern
        obs = as_tensor(observations, k.dtype, k.device)
        obs = obs.reshape(obs.shape[0], -1)
        inputs = as_tensor(inputs, k.dtype, k.device)
        carry = self.init(generator, inputs[0], init_state_mean, init_state_cov)
        log_weights, state, int_vars, Ss = carry
        moments = [self.moments(torch.softmax(log_weights, 0), state, int_vars, Ss)]
        for t in range(obs.shape[0] - 1):
            carry, mom = self.step(
                carry, obs[t + 1], inputs[t], inputs[t + 1], self.draws(generator)
            )
            moments.append(mom)
        return self.finish(moments, carry)


def build_sharded_apf(
    ssm: SSM,
    gps: Sequence[GPNode],
    n_particles: int,
    n_devices: int = 1,
    forgetting_factor: float = 1.0,
    dtype=torch.float32,
    resampling_scheme: str = "local",
    chunk_size: int | None = None,
    window: int | None = None,
    device: str | torch.device = "cuda",
    reference: bool = False,
    reuse_factor: bool = False,
    dedup_gather: bool = False,
) -> ShardedAPF:
    """Build the online APF sweep on one device (local scheme).

    ``device`` defaults to CUDA and raises if no card is present.
    ``reference=True`` runs the kernels' plain PyTorch versions in their
    place (on any device), to hold a sweep against the kernels.
    ``reuse_factor`` (the look-ahead's factor goes to the draw, as the JAX
    local scheme threads ``lws``, ``sharded.py:250-305``) and
    ``dedup_gather`` select the opt-in gather/draw kernels
    (:class:`~bipk_tpu_torch.algorithms.apf.APFKernel`).
    """
    if resampling_scheme not in ("local", "exact"):
        raise ValueError(
            f"resampling_scheme must be 'local' or 'exact', got {resampling_scheme!r}"
        )
    if n_devices != 1 or resampling_scheme != "local" or chunk_size is not None \
            or window is not None:
        raise NotImplementedError(
            "the port runs one device with the local resampling scheme, "
            "unchunked and unwindowed"
        )
    device = resolve_device(device)
    kern = APFKernel(ssm, gps, dtype, device, reference=reference,
                     reuse_factor=reuse_factor, dedup_gather=dedup_gather)
    return ShardedAPF(kern, n_particles, forgetting_factor)
