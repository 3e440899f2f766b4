"""The particle-sharded conditional SMC sweep (Algorithm 3) over a particle
mesh (port of ``bipk_tpu/parallel/sharded_csmc.py`` ``build_sharded_csmc``).

The sweep's step is the single-device cSMC step,
:meth:`CSMC.step <bipk_tpu_torch.algorithms.csmc.CSMC.step>`, with this
rank's operations in place of one device's, at the algorithm's
communication points (the JAX body's hand-placed collectives):

- the softmax of the first-stage, the ancestor and the new weights:
  ``pmax`` + ``psum`` of scalars; the ESS: one more ``psum``;
- the resampling: the exact global systematic scheme of
  :mod:`~bipk_tpu_torch.parallel.global_resampling` (the rank's slice of
  the global sorted ancestors: an ``all_gather`` of the ranks' masses and
  a ``psum`` of the offspring marker). The pinned slot must be able to
  take ANY global ancestor, so the local scheme does not apply;
- the reference's ancestor: one global categorical (an ``all_gather`` of
  the masses and a ``pmin`` of the ranks' first crossings);
- the payloads ``(state, int_vars, Ss, ll_aux)`` moved to their ancestors
  over the ring (W - 1 rotations), then the draw/update (#3) on the moved
  statistics: no gather in the kernel, no factor from the look-ahead.

The reference occupies the last slot of the last rank (global index
N - 1): that rank pins it, takes its ancestor's moved statistics plus the
reference's datum as its column, and every rank decrements the same
reference future. After the sweep, the final index is a global
categorical on the final weights; the ranks all-gather the ``(T-1,
n_loc)`` ancestor traces once, walk back on every rank, and take each row
of the trajectory from the rank that holds it with one ``psum``: a fixed
number of collectives per sweep, not one per step.

A one-rank mesh without a process group makes no collective: its
operations are the single-device ones but the resampling (the f64 closed
form in place of #2) and the move (the statistics gathered with the
payloads and #3 in place of #4's own gather).
"""

from __future__ import annotations

from typing import Sequence

import torch

from bipk_tpu_torch.algorithms.apf import APFKernel
from bipk_tpu_torch.algorithms.csmc import CSMC, CSMCDraws, CSMCResult, CSMCTrace, _at
from bipk_tpu_torch.models.ssm import GPNode, SSM
from bipk_tpu_torch.ops import resampling
from bipk_tpu_torch.parallel import global_resampling
from bipk_tpu_torch.parallel.mesh import ParticleMesh, mesh_on
from bipk_tpu_torch.parallel.sharded import rank_chunk, rank_width
from bipk_tpu_torch.utils.matio import map_leaves


class ShardedCSMC:
    """One rank's part of the particle-sharded cSMC sweep. Call it as
    :class:`~bipk_tpu_torch.algorithms.csmc.CSMC`: ``csmc(generator,
    observations, inputs, init_state_mean, init_state_cov, ref_state,
    ref_int_vars, ref_summed_stats)`` returns the same
    :class:`~bipk_tpu_torch.algorithms.csmc.CSMCResult` on every rank but
    for ``log_weights``, this rank's ``(n_loc,)`` slice. :meth:`init`,
    :meth:`draws`, :meth:`step`, :meth:`run` and :meth:`result` expose the
    pieces with injected draws.

    Generators, as :class:`~bipk_tpu_torch.parallel.sharded.ShardedAPF`'s:
    ``generator`` is seeded alike on every rank and draws what every rank
    must share (the resampling uniform, the reference ancestor's, the
    final trajectory's); each rank draws its particles' randomness (the
    initial particles, the process noise, the matrix-t uniforms) from its
    own generator (:meth:`~bipk_tpu_torch.parallel.mesh.ParticleMesh.
    rank_generator`, JAX's ``fold_in(key, shard)``), derived from
    ``generator`` at each sweep's start. On one rank both are
    ``generator``, drawn in the order of the single-device sweep.

    ``chunk_size`` runs each step chunk by chunk over the rank's particles
    (:meth:`step_chunked`).
    """

    def __init__(self, kern: APFKernel, n_particles: int, mesh: ParticleMesh,
                 chunk_size: int | None = None):
        self.kern = kern
        self.n_particles = n_particles
        self.mesh = mesh
        self.n_loc = n_particles // mesh.size
        self.chunk_size = chunk_size
        # the reference's slot, global N - 1, is the last rank's last
        self.holds_pinned = mesh.rank == mesh.size - 1
        self.csmc = CSMC(kern, self.n_loc)

    # -- the operations CSMC.step takes from this rank ---------------------

    def softmax(self, x):
        """This rank's slice of the globally normalized weights."""
        e = torch.exp(x - self.mesh.pmax(x.max()))
        return e / self.mesh.psum(e.sum())

    def psum(self, x):
        return self.mesh.psum(x)

    def resample(self, w, u):
        """This rank's slice of the global sorted systematic ancestors."""
        return global_resampling.global_systematic_slice(u, w, self.mesh)

    def categorical(self, w, u):
        """The reference's global ancestor, the same on every rank."""
        return global_resampling.global_categorical(u, w, self.mesh)

    def move(self, state, int_vars, ll_aux, Ss, ancestors):
        """The payloads and the statistics at their global ``ancestors``,
        over the ring. Returns ``(state, int_vars, ll_aux, Ss)``."""
        n_gp = self.kern.n_gp
        state_r, *rest = global_resampling.ring_redistribute(
            [state, *int_vars, *Ss, ll_aux], ancestors, self.mesh)
        return state_r, tuple(rest[:n_gp]), rest[-1], tuple(rest[n_gp:2 * n_gp])

    # -- the sweep -----------------------------------------------------------

    def draws(self, generator: torch.Generator,
              rank_generator: torch.Generator | None = None) -> CSMCDraws:
        """One step's draws for this rank's particles (the class
        docstring's rules; ``rank_generator`` defaults to ``generator``)."""
        rank_generator = rank_generator or generator
        k = self.kern
        d = k.step_draws(rank_generator, self.n_loc, u_generator=generator)
        u_ref = torch.rand((1,), generator=generator, dtype=k.dtype, device=k.device)
        return CSMCDraws(d.u_res, u_ref, d.z, d.uvs)

    def pin_initial(self, particles, ref_x0, ref_iv0, ref_T0, ref_summed_stats):
        """:meth:`CSMC.pin_initial <bipk_tpu_torch.algorithms.csmc.CSMC.
        pin_initial>` of this rank's particles: pinned on the last rank."""
        return self.csmc.pin_initial(particles, ref_x0, ref_iv0, ref_T0, ref_summed_stats,
                                     pin=self.holds_pinned)

    def init(self, generator, inputs0, init_mean, init_cov, ref_x0, ref_iv0,
             ref_T0, ref_summed_stats):
        """The initial carry of this rank's particles (``generator``: the
        rank's)."""
        return self.csmc.init(generator, inputs0, init_mean, init_cov, ref_x0, ref_iv0,
                              ref_T0, ref_summed_stats, pin=self.holds_pinned)

    def step(self, carry, obs, inp_prev, inp_cur, ref_x, ref_iv, ref_T, draws: CSMCDraws):
        """One step, :meth:`CSMC.step <bipk_tpu_torch.algorithms.csmc.CSMC.
        step>` on this rank's operations (:meth:`step_chunked` with
        ``chunk_size``). Returns ``(carry, (this rank's global ancestors,
        ess))``."""
        if self.chunk_size is not None:
            return self.step_chunked(carry, obs, inp_prev, inp_cur, ref_x, ref_iv, ref_T, draws)
        return self.csmc.step(carry, obs, inp_prev, inp_cur, ref_x, ref_iv, ref_T, draws,
                              ops=self)

    def step_chunked(self, carry, obs, inp_prev, inp_cur, ref_x, ref_iv, ref_T,
                     draws: CSMCDraws):
        """One step chunk by chunk (the JAX ``step_chunked``,
        ``sharded_csmc.py:305-447``), from the phases of :meth:`CSMC.step
        <bipk_tpu_torch.algorithms.csmc.CSMC.step>`: the look-ahead and
        the ancestor weights per chunk (each chunk's columns of S copied:
        the look-ahead takes contiguous statistics); the resampling, the
        reference's ancestor and the ring on the whole rank; then per chunk
        the propagation, #3 and the pin (the last chunk of the last rank)
        on the moved payloads. The step's draws are those of the unchunked
        step, sliced per chunk, so the chunked sweep computes what the
        unchunked sweep computes."""
        csmc, C, n_gp = self.csmc, self.chunk_size, self.kern.n_gp
        log_weights, state, int_vars, Ss, ref_stats = carry
        chunks = [slice(c, c + C) for c in range(0, self.n_loc, C)]
        parts = [csmc.lookahead((log_weights[sl], state[:, sl],
                                 tuple(iv[:, sl] for iv in int_vars),
                                 tuple(S[:, sl].contiguous() for S in Ss), ref_stats),
                                obs, inp_prev, inp_cur, ref_x)
                 for sl in chunks]
        lw_aux, ll_aux, lw_as = (torch.cat([p[k] for p in parts]) for k in range(3))
        ancestors_sorted, ancestors, ref_idx = csmc.select(lw_aux, lw_as, draws, self)
        state_m, iv_m, ll_aux_m, Ss_m = self.move(state, int_vars, ll_aux, Ss, ancestors)
        new_lw, new_state, new_iv, new_Ss = map_leaves(
            torch.empty_like, [(log_weights, state, int_vars, Ss)])
        for sl in chunks:
            moved = (state_m[:, sl], tuple(iv[:, sl] for iv in iv_m), ll_aux_m[sl],
                     tuple(S[:, sl].contiguous() for S in Ss_m))
            uvs = tuple((u[:, sl].contiguous(), v[:, sl].contiguous()) for u, v in draws.uvs)
            lw_c, state_c, iv_c, Ss_c = csmc.advance(
                moved, Ss, ancestors_sorted, ref_idx, obs, inp_prev, inp_cur, ref_x, ref_iv,
                None if draws.z is None else draws.z[:, sl], uvs, (None,) * n_gp,
                self.holds_pinned and sl.stop == self.n_loc)
            new_lw[sl] = lw_c
            new_state[:, sl] = state_c
            for i in range(n_gp):
                new_iv[i][:, sl] = iv_c[i]
                new_Ss[i][:, sl] = Ss_c[i]
        return csmc.close((new_lw, new_state, new_iv, new_Ss), ref_stats, ref_T, ancestors,
                          self)

    def run(self, carry, obs, inputs, ref_state, ref_ivs, ref_T, draws) -> CSMCTrace:
        """:meth:`CSMC.run <bipk_tpu_torch.algorithms.csmc.CSMC.run>` with
        this rank's :meth:`step`: traces of this rank's particles, the
        ancestors as global indices, the ESS of the global weights."""
        return self.csmc.run(carry, obs, inputs, ref_state, ref_ivs, ref_T, draws,
                             step=self.step)

    def trace(self, generator, observations, inputs, init_state_mean, init_state_cov,
              ref_state, ref_int_vars, ref_summed_stats) -> CSMCTrace:
        """One sweep with this rank's batch-last traces."""
        obs, inputs, ref_state, ref_ivs, ref_summed, ref_T = self.csmc.prepare(
            observations, inputs, ref_state, ref_int_vars, ref_summed_stats)
        rank_gen = self.mesh.rank_generator(generator)
        carry = self.init(rank_gen, inputs[0], init_state_mean, init_state_cov,
                          ref_state[0], tuple(r[0] for r in ref_ivs), _at(ref_T, 0), ref_summed)
        draws = (self.draws(generator, rank_gen) for _ in range(obs.shape[0] - 1))
        return self.run(carry, obs, inputs, ref_state, ref_ivs, ref_T, draws)

    def result(self, tr: CSMCTrace, u) -> CSMCResult:
        """The sweep's result from this rank's trace and the uniform ``u``
        (the same on every rank): the final index by a global categorical,
        the ancestor traces all-gathered once and walked back on every
        rank, each row of the trajectory taken from the rank that holds it
        with one ``psum`` of the masked ``(T, dx + sum n_i)`` rows."""
        mesh, n_loc = self.mesh, self.n_loc
        idx = self.categorical(self.softmax(tr.final_log_weights), u)
        indices = resampling.backward_indices(mesh.all_gather_last(tr.ancestors), idx)
        local = indices - mesh.rank * n_loc
        mine = (local >= 0) & (local < n_loc)
        steps = torch.arange(indices.shape[0], device=indices.device)
        cols = local.clamp(0, n_loc - 1)
        rows = torch.cat([tr.states.movedim(-1, 1)[steps, cols],
                          *(iv.movedim(-1, 1)[steps, cols] for iv in tr.int_vars)], 1)
        rows = mesh.psum(torch.where(mine[:, None], rows, torch.zeros_like(rows)))
        state_traj, *iv_traj = torch.split(
            rows, [tr.states.shape[1], *(iv.shape[1] for iv in tr.int_vars)], 1)
        return CSMCResult(state_traj, tuple(iv_traj), tr.ess, tr.final_log_weights)

    def __call__(self, generator, observations, inputs, init_state_mean, init_state_cov,
                 ref_state, ref_int_vars, ref_summed_stats) -> CSMCResult:
        tr = self.trace(generator, observations, inputs, init_state_mean, init_state_cov,
                        ref_state, ref_int_vars, ref_summed_stats)
        u = torch.rand((1,), generator=generator, dtype=self.kern.dtype,
                       device=self.kern.device)
        return self.result(tr, u)


def build_sharded_csmc(
    ssm: SSM,
    gps: Sequence[GPNode],
    n_particles: int,
    mesh: ParticleMesh | None = None,
    dtype=torch.float32,
    chunk_size: int | None = None,
    device: str | torch.device | None = None,
    reference: bool = False,
) -> ShardedCSMC:
    """Build this rank's part of the particle-sharded cSMC sweep; the call
    and the result are ``build_csmc``'s (:class:`ShardedCSMC`).

    ``mesh`` (:func:`~bipk_tpu_torch.parallel.mesh.particle_mesh`, or
    :func:`~bipk_tpu_torch.parallel.distributed.global_particle_mesh` on a
    process group) splits the ``n_particles`` over its ranks; None is a
    one-rank mesh on ``device``. ``device`` defaults to the mesh's, else
    CUDA, and raises if no card is present; it must be the mesh's.
    ``reference=True`` runs the kernels' plain PyTorch versions in their
    place (on any device).

    ``chunk_size`` runs each step in chunks of the rank's particles
    (:meth:`ShardedCSMC.step_chunked`); a chunk of ``n_loc`` or more runs
    unchunked. The sweep does not chunk by itself as the JAX package does
    above 262144 particles per shard (``sharded_csmc.py:81-82``, a plan for
    a 16 GB TPU chip): on the 80 GB card chunking never decides whether a
    sweep fits. Its peak is the traces, ``T (dx + sum n_i + 1)`` 4-byte
    values per particle (the vehicle at 1500 steps: 30 KB), beside the
    carries, the ring's packed payloads and one step's temporaries (4-6 KB
    per particle, ~2 KB less in chunks): the traces fill 80 GB near 2.3 M
    particles per card either way. The argument checks the
    JAX package makes first (``sharded_csmc.py:76-89``) raise
    ``ValueError`` as there.
    """
    mesh = mesh_on(mesh, device)
    n_loc = rank_width(n_particles, mesh)
    kern = APFKernel(ssm, gps, dtype, mesh.device, reference=reference)
    return ShardedCSMC(kern, n_particles, mesh, rank_chunk(chunk_size, n_loc))
