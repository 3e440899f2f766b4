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

One device and the local scheme, as one full-width step per observation
(the default), in chunks of the particle axis (``chunk_size``: the JAX
``step_chunked``), and with the moments brought to the host every
``window`` steps (the JAX windowed dispatch); more devices and the exact
scheme raise (ROADMAP Queue A item 8).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from bipk_tpu_torch._device import resolve_device
from bipk_tpu_torch.algorithms.apf import APF, APFKernel, StepDraws, as_tensor
from bipk_tpu_torch.models.ssm import GPNode, SSM
from bipk_tpu_torch.ops import mniw
from bipk_tpu_torch.utils.matio import map_leaves, to_host


# No automatic chunking on the 80 GB card. The JAX package chunks by
# itself above 262144 particles per shard (``sharded.py:113-117``), a
# plan for a 16 GB TPU chip. Here a sweep's peak memory is its end, where
# the final statistics are unpacked to ``(m, m, N)`` beside the final
# carry: for the vehicle (two GPs, m = 20, n = 1, 232 packed rows) 4 B x
# 2 x (232 + 422) ~ 5.2 KB per particle, against 4 B x 2 x (2 x 232 +
# ~32) ~ 4.0 KB during an unchunked step (old and new carries and the
# full-width temporaries) and 3.7 KB during a chunked one (the two
# carries). Chunking never decides whether a sweep fits (both stop near
# 80 GB / 5.2 KB ~ 15 M particles), so the port chunks only when asked.
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
    :meth:`step` expose one step with injected draws.

    ``chunk_size`` runs each step chunk by chunk over the particle axis
    (:meth:`step_chunked`); ``window`` brings the moments to the host as
    numpy every ``window`` steps, so the result's moment fields
    (``state_mean``, ``int_var_mean``, ``stats_mean``, ``ess``) are numpy
    arrays, bit for bit those of the sweep without ``window``."""

    def __init__(self, kern: APFKernel, n_particles: int, forgetting_factor: float,
                 chunk_size: int | None = None, window: int | None = None):
        self.kern = kern
        self.n_particles = n_particles
        self.lam = forgetting_factor
        self.chunk_size = chunk_size
        self.window = window
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

    def step(self, carry, obs, inp_prev, inp_cur, draws: StepDraws, out=None):
        """One filter step (:meth:`APF.step`, or :meth:`step_chunked` with
        ``chunk_size``, which writes into ``out`` if given); returns
        ``(carry, moments)``. With one shard the local scheme's shard mass
        is the global softmax's sum, 1 up to rounding: the systematic
        kernel takes unnormalized weights, and the log-weight offset
        log(mass) shifts every weight alike, so neither is applied."""
        if self.chunk_size is None:
            carry, _ = self._filter.step(carry, obs, inp_prev, inp_cur, draws)
        else:
            carry = self.step_chunked(carry, obs, inp_prev, inp_cur, draws, out)
        return carry, self.moments(torch.softmax(carry[0], 0), *carry[1:])

    def step_chunked(self, carry, obs, inp_prev, inp_cur, draws: StepDraws, out=None):
        """One filter step chunk by chunk (the JAX ``step_chunked``,
        ``sharded.py:315-426``): the look-ahead (#1) per chunk; the
        softmax and the systematic resampler (#2) over all N; then per
        chunk the gather and propagation, the gather/draw (#4) of the
        chunk's ``N_out = chunk`` particles from the full statistics, and
        the log-likelihood. The step's draws are those of the unchunked
        step, sliced per chunk, so on one generator the chunked sweep
        computes what the unchunked sweep computes. The new carry streams
        into ``out`` (a carry of the same shapes, not ``carry`` itself;
        allocated here if None). The look-ahead kernel takes contiguous
        statistics, so each chunk's columns of S are copied first (at
        m = 20 and a chunk of 32768, 30 MB per GP); the draw kernel's
        chunk of the new statistics is copied into ``out``."""
        kern, lam, C = self.kern, self.lam, self.chunk_size
        log_weights, state, int_vars, Ss = carry
        if out is None:
            out = map_leaves(torch.empty_like, [carry])
        new_lw, new_state, new_iv, new_Ss = out
        chunks = [slice(c, c + C) for c in range(0, self.n_particles, C)]
        ll_aux = torch.empty_like(log_weights)
        for sl in chunks:
            ll_aux[sl] = kern.auxiliary_fused_packed_f(
                tuple(S[:, sl].contiguous() for S in Ss), lam, state[:, sl],
                tuple(iv[:, sl] for iv in int_vars), inp_prev, inp_cur, obs,
                log_weights[sl], emit_factor=False,
            )[3]
        ancestors = kern.resample(torch.softmax(ll_aux + log_weights, 0), draws.u_res)
        for sl in chunks:
            idx = ancestors[sl]
            state_g, *iv_g, ll_aux_g = kern.packed_gather([state, *int_vars, ll_aux], idx)
            z = None if draws.z is None else draws.z[:, sl]
            new_state_c = kern.propagate_all(z, state_g, inp_prev, iv_g)
            uvs = tuple((u[:, sl].contiguous(), v[:, sl].contiguous()) for u, v in draws.uvs)
            Ss_c, iv_c, _, _ = kern.draw_update_gather_all_packed(
                uvs, Ss, idx, lam, new_state_c, inp_cur)
            new_lw[sl] = kern.log_lik_all(obs, new_state_c, inp_cur, iv_c) - ll_aux_g
            new_state[:, sl] = new_state_c
            for i in range(kern.n_gp):
                new_iv[i][:, sl] = iv_c[i]
                new_Ss[i][:, sl] = Ss_c[i]
        return out

    def stack_moments(self, moments: list):
        """Per-step moments -> ``(state_mean (k, dx), int_var_mean, stats_mean
        (unpacked MNIW per GP), ess (k,))``."""
        kern = self.kern
        sm, ivm, red, ess = zip(*moments)
        return (
            torch.stack(sm),
            tuple(torch.stack([v[i] for v in ivm]) for i in range(kern.n_gp)),
            tuple(
                mniw.unpack_reduced(torch.stack([r[i] for r in red]), kern.ms[i], kern.ns[i])
                for i in range(kern.n_gp)
            ),
            torch.stack(ess),
        )

    def finish(self, moments: list, carry) -> ShardedAPFResult:
        """Stack per-step moments and unpack the final statistics."""
        return self.result(self.stack_moments(moments), carry)

    def result(self, stacked, carry) -> ShardedAPFResult:
        """The stacked moments (:meth:`stack_moments`, on the device or on
        the host) and the final carry, its statistics unpacked."""
        kern = self.kern
        final_log_w, final_state, _, final_Ss = carry
        final_stats = tuple(
            mniw.from_flat_bl(mniw.unpack_stats_bl(S, kern.ms[i], kern.ns[i]),
                              kern.ms[i], kern.ns[i])
            for i, S in enumerate(final_Ss)
        )
        return ShardedAPFResult(*stacked, final_state.T, final_log_w, final_stats)

    def __call__(
        self, generator: torch.Generator, observations, inputs,
        init_state_mean, init_state_cov,
    ) -> ShardedAPFResult:
        k = self.kern
        obs = as_tensor(observations, k.dtype, k.device)
        obs = obs.reshape(obs.shape[0], -1)
        inputs = as_tensor(inputs, k.dtype, k.device)
        carry = self.init(generator, inputs[0], init_state_mean, init_state_cov)
        moments = [self.moments(torch.softmax(carry[0], 0), *carry[1:])]
        # the chunked step's two carries, allocated once per sweep
        spare = None if self.chunk_size is None else map_leaves(torch.empty_like, [carry])
        n_steps = obs.shape[0] - 1
        win = self.window or max(n_steps, 1)
        pieces = []
        for s in range(0, n_steps, win):
            for t in range(s, min(s + win, n_steps)):
                new, mom = self.step(carry, obs[t + 1], inputs[t], inputs[t + 1],
                                     self.draws(generator), out=spare)
                if spare is not None:
                    spare = carry
                carry = new
                moments.append(mom)
            if self.window is not None:  # this piece's moments to the host
                pieces.append(to_host(self.stack_moments(moments)))
                moments = []
        del spare  # the final statistics unpack beside one carry, not two
        if self.window is None:
            return self.finish(moments, carry)
        if moments:  # no step: the initial moments alone
            pieces.append(to_host(self.stack_moments(moments)))
        # the pieces' arrays concatenated along their first axis, leaf by leaf
        return self.result(map_leaves(lambda *a: np.concatenate(a), pieces, leaf=np.ndarray),
                           carry)


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

    ``chunk_size`` runs each step in chunks of the particle axis
    (:meth:`ShardedAPF.step_chunked`): the carries stay full-width, the
    per-chunk temporaries are one chunk. The sweep does not chunk by
    itself as the JAX package does above 262144 particles: on the 80 GB
    card chunking never decides whether a sweep fits (the arithmetic is
    at the top of this module). On the H100 it is there for parity with
    the JAX API and for no workload: it never lowers the sweep's peak
    memory, and its step is host-bound (at 2**20 particles in chunks of
    32768, about 31 times the launches of an unchunked step;
    ``chip_smoke.py`` phase 26 prints both). A ``chunk_size`` of N or
    more runs unchunked. As in the JAX chunked step, ``reuse_factor`` and
    ``dedup_gather`` do not apply there: it threads no factor and runs the
    gather/draw kernel (#4). ``window`` brings the moments to the host
    every ``window`` steps (the JAX windowed dispatch); it composes with
    ``chunk_size``. More devices and the exact scheme are not ported
    (ROADMAP Queue A item 8); the argument checks the JAX package makes
    first (``sharded.py:79-131``) raise ``ValueError`` as there.
    """
    if resampling_scheme not in ("local", "exact"):
        raise ValueError(
            f"resampling_scheme must be 'local' or 'exact', got {resampling_scheme!r}"
        )
    if n_particles % n_devices:
        raise ValueError(f"n_particles={n_particles} not divisible by mesh size {n_devices}")
    n_loc = n_particles // n_devices
    if chunk_size is not None and chunk_size >= n_loc:
        chunk_size = None
    if chunk_size is not None:
        if resampling_scheme != "local":
            raise ValueError(
                "chunked execution supports the local resampling scheme only (at multi-chip "
                "scale the per-shard slice is small enough not to need chunking)"
            )
        if chunk_size <= 0 or n_loc % chunk_size:
            raise ValueError(
                f"per-shard particle count {n_loc} not divisible by chunk_size {chunk_size}"
            )
        reuse_factor = dedup_gather = False
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if n_devices != 1 or resampling_scheme != "local":
        raise NotImplementedError(
            "the port runs one device with the local resampling scheme; more devices and "
            "the exact scheme are ROADMAP Queue A item 8"
        )
    device = resolve_device(device)
    kern = APFKernel(ssm, gps, dtype, device, reference=reference,
                     reuse_factor=reuse_factor, dedup_gather=dedup_gather)
    return ShardedAPF(kern, n_particles, forgetting_factor, chunk_size, window)
