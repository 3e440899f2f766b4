"""The particle-sharded online APF sweep over a particle mesh (port of
``bipk_tpu/parallel/sharded.py`` ``build_sharded_apf``).

Per step: the auxiliary look-ahead (one factorize+project kernel per GP,
which with ``reuse_factor`` also emits the factor), resampling on the
first-stage weights, a gather of the small per-particle payloads and the
RK4 propagation, the matrix-t draw + rank-1 statistics update (one kernel
per GP), the log-likelihood, and the weighted moments. Traces reduce to
weighted moments on the fly, as in the JAX package.

The particle axis is split over the ranks of a :class:`~bipk_tpu_torch.
parallel.mesh.ParticleMesh`, ``n_loc = N / W`` particles per rank. Its
collectives, as in the JAX body: the global softmax (``pmax`` + ``psum``),
the weighted moments and the ESS (one ``psum`` of the local partials),
and, per resampling scheme:

- ``"local"`` (default): each rank resamples its slice with the
  systematic kernel from its locally renormalized weights, draws with the
  gather/draw kernel (or an opt-in one), and carries its share of the
  global mass as the log-weight offset ``log(max(mass W, 1e-30))``: no
  particle crosses ranks.
- ``"exact"``: the single-device global systematic scheme on the mesh
  (:mod:`~bipk_tpu_torch.parallel.global_resampling`): the rank's slice of
  the global sorted ancestors, the payloads ``(state, int_vars, Ss,
  ll_aux)`` moved over the ring, then the draw/update kernel on the
  redistributed statistics, without a gather and without the look-ahead's
  factor; offset 0.

A one-rank mesh with the local scheme is the single-device sweep, the
JAX package's one-device fast path (``sharded.py:152-184``): no
collective, no mass renormalization, no offset. It runs as one full-width
step per observation (the default), in chunks of the particle axis
(``chunk_size``: the JAX ``step_chunked``; local scheme only), and with
the moments brought to the host every ``window`` steps (the JAX windowed
dispatch); both compose with W ranks.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from bipk_tpu_torch.algorithms.apf import APF, APFKernel, StepDraws, as_tensor
from bipk_tpu_torch.models.ssm import GPNode, SSM
from bipk_tpu_torch.ops import mniw
from bipk_tpu_torch.parallel import global_resampling
from bipk_tpu_torch.parallel.mesh import ParticleMesh, mesh_on
from bipk_tpu_torch.utils.matio import map_leaves, to_host


def rank_width(n_particles: int, mesh: ParticleMesh) -> int:
    """The particles per rank, ``n_particles / W``; raises unless W
    divides ``n_particles``."""
    if n_particles % mesh.size:
        raise ValueError(f"n_particles={n_particles} not divisible by mesh size {mesh.size}")
    return n_particles // mesh.size


def rank_chunk(chunk_size: int | None, n_loc: int) -> int | None:
    """A sweep's chunk of the rank's ``n_loc`` particles: None (unchunked)
    for None or a chunk of ``n_loc`` or more; raises unless the chunk
    divides ``n_loc``."""
    if chunk_size is None or chunk_size >= n_loc:
        return None
    if chunk_size <= 0 or n_loc % chunk_size:
        raise ValueError(
            f"per-shard particle count {n_loc} not divisible by chunk_size {chunk_size}"
        )
    return chunk_size


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
    state_mean: torch.Tensor  # (T, dx) weighted posterior mean, equal on every rank
    int_var_mean: tuple  # each (T, n_i)
    stats_mean: tuple  # each MNIW with leading (T, ...)
    ess: torch.Tensor  # (T,)
    final_state: torch.Tensor  # (n_loc, dx): this rank's slice
    final_log_weights: torch.Tensor  # (n_loc,)
    final_stats: tuple  # each MNIW batch-last (..., n_loc)


class ShardedAPF:
    """One rank's part of the sharded online APF sweep, reducing its traces
    to weighted moments on the fly. Call it as ``apf(generator,
    observations, inputs, init_state_mean, init_state_cov)``; :meth:`init`,
    :meth:`draws` and :meth:`step` expose one step with injected draws.

    Generators: ``generator`` is seeded alike on every rank. On one rank it
    draws everything, in the order of the single-device sweep. On W ranks
    each rank draws its particles' randomness (the initial particles, the
    process noise, the matrix-t uniforms) from its own generator
    (:meth:`~bipk_tpu_torch.parallel.mesh.ParticleMesh.rank_generator`),
    the counterpart of JAX's ``fold_in(key, shard)``; the resampling uniform ``u_res`` comes from ``generator``
    in the exact scheme (so it is the same on every rank) and from the
    rank's generator in the local one (JAX's ``fold_in(key_res, shard)``).

    ``chunk_size`` runs each step chunk by chunk over the particle axis
    (:meth:`step_chunked`); ``window`` brings the moments to the host as
    numpy every ``window`` steps, so the result's moment fields
    (``state_mean``, ``int_var_mean``, ``stats_mean``, ``ess``) are numpy
    arrays, bit for bit those of the sweep without ``window``."""

    def __init__(self, kern: APFKernel, n_particles: int, forgetting_factor: float,
                 mesh: ParticleMesh, chunk_size: int | None = None,
                 window: int | None = None, resampling_scheme: str = "local"):
        self.kern = kern
        self.n_particles = n_particles
        self.lam = forgetting_factor
        self.chunk_size = chunk_size
        self.window = window
        self.mesh = mesh
        self.exact = resampling_scheme == "exact"
        self.n_loc = n_particles // mesh.size
        # the single-device sweep: one rank, local scheme
        self.single = mesh.size == 1 and not self.exact
        self._filter = APF(kern, self.n_loc, forgetting_factor)

    def draws(self, generator: torch.Generator,
              rank_generator: torch.Generator | None = None) -> StepDraws:
        """One step's draws for this rank's particles (the class docstring's
        rules; ``rank_generator`` defaults to ``generator``)."""
        rank_generator = rank_generator or generator
        return self.kern.step_draws(rank_generator, self.n_loc,
                                    u_generator=generator if self.exact else None)

    def init(self, generator, inputs0, init_mean, init_cov):
        """Initial carry ``(log_weights, state, int_vars, Ss)`` of this
        rank's particles (``generator``: the rank's)."""
        return self.kern.init_particles(generator, self.n_loc, inputs0, init_mean, init_cov)

    def softmax(self, log_weights):
        """This rank's slice of the globally normalized weights."""
        if self.single:
            return torch.softmax(log_weights, 0)
        e = torch.exp(log_weights - self.mesh.pmax(log_weights.max()))
        return e / self.mesh.psum(e.sum())

    def moments(self, w, state, int_vars, Ss):
        """Weighted moments ``(state_mean, int_var_means, reduced packed
        statistics per GP, ess)`` for the global weights' slice ``w``: the
        local partials, summed over the ranks in one ``psum``."""
        parts = [state @ w, *(iv @ w for iv in int_vars),
                 *self.kern.weighted_stats_packed(Ss, w)]
        sumsq = (w * w).sum()
        if not self.single:
            flat = self.mesh.psum(torch.cat([*parts, sumsq.reshape(1)]))
            parts = torch.split(flat[:-1], [p.shape[0] for p in parts])
            sumsq = flat[-1]
        n_gp = self.kern.n_gp
        return parts[0], tuple(parts[1:1 + n_gp]), tuple(parts[1 + n_gp:]), 1.0 / sumsq

    def local_ancestors(self, w, u):
        """The local scheme's resampling of this rank's slice ``w`` of the
        global weights: ``(ancestors, log-weight offset)``. On one rank the
        kernel takes ``w`` as it is (the systematic kernel normalizes), and
        the offset log(mass), the same for every particle, is None."""
        if self.single:
            return self.kern.resample(w, u), None
        mass = w.sum()
        w_local = w / mass.clamp_min(1e-30)
        return (self.kern.resample(w_local, u),
                torch.log((mass * self.mesh.size).clamp_min(1e-30)))

    def step(self, carry, obs, inp_prev, inp_cur, draws: StepDraws, out=None):
        """One filter step, :meth:`step_chunked` with ``chunk_size`` (which
        writes into ``out`` if given); returns ``(carry, moments)``."""
        if self.chunk_size is not None:
            carry = self.step_chunked(carry, obs, inp_prev, inp_cur, draws, out)
        elif self.exact:
            carry, _ = self.step_exact(carry, obs, inp_prev, inp_cur, draws)
        else:
            carry, _ = self.step_local(carry, obs, inp_prev, inp_cur, draws)
        return carry, self.moments(self.softmax(carry[0]), *carry[1:])

    def step_local(self, carry, obs, inp_prev, inp_cur, draws: StepDraws):
        """The local scheme (``sharded.py:242-313``): the single-device
        step (:meth:`APF.step <bipk_tpu_torch.algorithms.apf.APF.step>`:
        the look-ahead, #1 or 1e with ``reuse_factor``; the gather/draw, #4
        or an opt-in) on the rank's particles, resampled by
        :meth:`local_ancestors` (the systematic kernel, #2, on the rank's
        renormalized slice, and the mass offset). Returns ``(carry,
        ancestors)``."""
        return self._filter.step(
            carry, obs, inp_prev, inp_cur, draws,
            resample=lambda lw_aux: self.local_ancestors(self.softmax(lw_aux), draws.u_res))

    def step_exact(self, carry, obs, inp_prev, inp_cur, draws: StepDraws):
        """The exact scheme (``sharded.py:242-313``): the look-ahead (#1, no
        factor: the draw refactors the moved statistics, cheaper than
        moving the factor too), the rank's slice of the global systematic
        ancestors, the payloads over the ring, the draw/update (#3) on the
        redistributed statistics, offset 0. Returns ``(carry, this rank's
        global ancestors)``."""
        kern, lam, n_gp = self.kern, self.lam, self.kern.n_gp
        log_weights, state, int_vars, Ss = carry
        _, _, lw_aux, ll_aux, _, _ = kern.auxiliary_fused_packed_f(
            Ss, lam, state, int_vars, inp_prev, inp_cur, obs, log_weights,
            emit_factor=False,
        )
        anc = global_resampling.global_systematic_slice(
            draws.u_res, self.softmax(lw_aux), self.mesh)
        state_r, *rest = global_resampling.ring_redistribute(
            [state, *int_vars, *Ss, ll_aux], anc, self.mesh)
        iv_r, Ss_r, ll_aux_r = rest[:n_gp], rest[n_gp:2 * n_gp], rest[-1]
        new_state = kern.propagate_all(draws.z, state_r, inp_prev, iv_r)
        Ss_new, new_iv, _, _ = kern.draw_update_all_packed(
            draws.uvs, Ss_r, lam, new_state, inp_cur)
        new_lw = kern.log_lik_all(obs, new_state, inp_cur, new_iv) - ll_aux_r
        return (new_lw, new_state, new_iv, Ss_new), anc

    def step_chunked(self, carry, obs, inp_prev, inp_cur, draws: StepDraws, out=None):
        """One filter step chunk by chunk (the JAX ``step_chunked``,
        ``sharded.py:315-426``; local scheme): the look-ahead (#1) per
        chunk; the softmax and the systematic resampler (#2) over the
        rank's ``n_loc``; then per chunk the gather and propagation, the
        gather/draw (#4) of the chunk's ``N_out = chunk`` particles from the
        rank's statistics, and the log-likelihood. The step's draws are
        those of the unchunked step, sliced per chunk, so on one generator
        the chunked sweep computes what the unchunked sweep computes. The
        new carry streams into ``out`` (a carry of the same shapes, not
        ``carry`` itself; allocated here if None). The look-ahead kernel
        takes contiguous statistics, so each chunk's columns of S are
        copied first (at m = 20 and a chunk of 32768, 30 MB per GP); the
        draw kernel's chunk of the new statistics is copied into ``out``."""
        kern, lam, C = self.kern, self.lam, self.chunk_size
        log_weights, state, int_vars, Ss = carry
        if out is None:
            out = map_leaves(torch.empty_like, [carry])
        new_lw, new_state, new_iv, new_Ss = out
        chunks = [slice(c, c + C) for c in range(0, self.n_loc, C)]
        ll_aux = torch.empty_like(log_weights)
        for sl in chunks:
            ll_aux[sl] = kern.auxiliary_fused_packed_f(
                tuple(S[:, sl].contiguous() for S in Ss), lam, state[:, sl],
                tuple(iv[:, sl] for iv in int_vars), inp_prev, inp_cur, obs,
                log_weights[sl], emit_factor=False,
            )[3]
        ancestors, offset = self.local_ancestors(self.softmax(ll_aux + log_weights),
                                                 draws.u_res)
        for sl in chunks:
            idx = ancestors[sl]
            state_g, *iv_g, ll_aux_g = kern.packed_gather([state, *int_vars, ll_aux], idx)
            z = None if draws.z is None else draws.z[:, sl]
            new_state_c = kern.propagate_all(z, state_g, inp_prev, iv_g)
            uvs = tuple((u[:, sl].contiguous(), v[:, sl].contiguous()) for u, v in draws.uvs)
            Ss_c, iv_c, _, _ = kern.draw_update_gather_all_packed(
                uvs, Ss, idx, lam, new_state_c, inp_cur)
            lw_c = kern.log_lik_all(obs, new_state_c, inp_cur, iv_c) - ll_aux_g
            new_lw[sl] = lw_c if offset is None else lw_c + offset
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
        rank_gen = self.mesh.rank_generator(generator)
        carry = self.init(rank_gen, inputs[0], init_state_mean, init_state_cov)
        moments = [self.moments(self.softmax(carry[0]), *carry[1:])]
        # the chunked step's two carries, allocated once per sweep
        spare = None if self.chunk_size is None else map_leaves(torch.empty_like, [carry])
        n_steps = obs.shape[0] - 1
        win = self.window or max(n_steps, 1)
        pieces = []
        for s in range(0, n_steps, win):
            for t in range(s, min(s + win, n_steps)):
                new, mom = self.step(carry, obs[t + 1], inputs[t], inputs[t + 1],
                                     self.draws(generator, rank_gen), out=spare)
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


def gather_final(result: ShardedAPFResult, mesh: ParticleMesh) -> ShardedAPFResult:
    """``result`` with the full-N final carry on every rank, rank slices in
    rank order (the moments are already equal on every rank)."""
    final_state = mesh.all_gather_last(result.final_state.T.contiguous()).T
    return result._replace(
        final_state=final_state,
        final_log_weights=mesh.all_gather_last(result.final_log_weights),
        final_stats=tuple(type(st)(*(mesh.all_gather_last(leaf.contiguous()) for leaf in st))
                          for st in result.final_stats),
    )


def build_sharded_apf(
    ssm: SSM,
    gps: Sequence[GPNode],
    n_particles: int,
    mesh: ParticleMesh | None = None,
    forgetting_factor: float = 1.0,
    dtype=torch.float32,
    resampling_scheme: str = "local",
    chunk_size: int | None = None,
    window: int | None = None,
    device: str | torch.device | None = None,
    reference: bool = False,
    reuse_factor: bool = False,
    dedup_gather: bool = False,
) -> ShardedAPF:
    """Build this rank's part of the sharded online APF sweep.

    ``mesh`` (:func:`~bipk_tpu_torch.parallel.mesh.particle_mesh`, or
    :func:`~bipk_tpu_torch.parallel.distributed.global_particle_mesh` on a
    process group) splits the ``n_particles`` over its ranks; None is a
    one-rank mesh on ``device``. ``device`` defaults to the mesh's, else
    CUDA, and raises if no card is present; it must be the mesh's.
    ``reference=True`` runs the kernels' plain PyTorch versions in their
    place (on any device), to hold a sweep against the kernels.
    ``reuse_factor`` (the look-ahead's factor goes to the draw, as the JAX
    local scheme threads ``lws``, ``sharded.py:250-305``) and
    ``dedup_gather`` select the opt-in gather/draw kernels
    (:class:`~bipk_tpu_torch.algorithms.apf.APFKernel`).

    ``chunk_size`` runs each step in chunks of the rank's particle axis
    (:meth:`ShardedAPF.step_chunked`; the local scheme only, as in JAX):
    the carries stay full-width, the per-chunk temporaries are one chunk.
    The sweep does not chunk by itself as the JAX package does above
    262144 particles: on the 80 GB card chunking never decides whether a
    sweep fits (the arithmetic is at the top of this module). On the H100
    it is there for parity with the JAX API and for no workload: it never
    lowers the sweep's peak memory, and its step is host-bound (at 2**20
    particles in chunks of 32768, about 31 times the launches of an
    unchunked step; ``chip_smoke.py`` phase 26 prints both). A
    ``chunk_size`` of ``n_loc`` or more runs unchunked. As in the JAX
    chunked step, ``reuse_factor`` and ``dedup_gather`` do not apply
    there: it threads no factor and runs the gather/draw kernel (#4); nor
    in the exact scheme, whose draw (#3) gathers nothing and whose
    look-ahead emits no factor. ``window`` brings the moments to the host
    every ``window`` steps (the JAX windowed dispatch); it composes with
    ``chunk_size`` and with W ranks. The argument checks the JAX package
    makes first (``sharded.py:79-131``) raise ``ValueError`` as there.
    """
    if resampling_scheme not in ("local", "exact"):
        raise ValueError(
            f"resampling_scheme must be 'local' or 'exact', got {resampling_scheme!r}"
        )
    mesh = mesh_on(mesh, device)
    n_loc = rank_width(n_particles, mesh)
    if chunk_size is not None and chunk_size < n_loc and resampling_scheme != "local":
        raise ValueError(
            "chunked execution supports the local resampling scheme only (at multi-chip "
            "scale the per-shard slice is small enough not to need chunking)"
        )
    chunk_size = rank_chunk(chunk_size, n_loc)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if chunk_size is not None or resampling_scheme == "exact":
        reuse_factor = dedup_gather = False
    kern = APFKernel(ssm, gps, dtype, mesh.device, reference=reference,
                     reuse_factor=reuse_factor, dedup_gather=dedup_gather)
    return ShardedAPF(kern, n_particles, forgetting_factor, mesh, chunk_size, window,
                      resampling_scheme)
