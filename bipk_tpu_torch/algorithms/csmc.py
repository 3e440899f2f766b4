"""Algorithm 3: conditional SMC with ancestor sampling, GP parameters
marginalized (port of ``bipk_tpu/algorithms/csmc.py``: ``step_direct``,
``step_rank1`` and ``run``).

An APF sweep with the forgetting factor pinned to 1 in which the last
particle follows the reference trajectory. Each step:

1. the auxiliary look-ahead (one factorize+project kernel per GP);
2. systematic resampling on the first-stage weights (one kernel);
3. the reference's ancestor, drawn with parameter-marginalized weights:
   the log base measure of each particle's statistics without the
   reference's future (from the look-ahead's log-determinants) minus the
   one with it (one log-determinant kernel per GP, the future statistics
   folded into its prior), plus the transition density to the reference;
4. a gather of the small payloads with the patched ancestors, the RK4
   propagation, and the fused gather + matrix-t draw + rank-1 update (one
   kernel per GP; with ``reuse_factor`` it reads the look-ahead's factor)
   with the SORTED, unpatched ancestors; the reference's column and
   interface variables are then written over the kernel's fresh output;
5. the reference's contribution at this step leaves its future statistics.

The rank-1 formulation (``rank1=True``, :class:`CSMCRank1`) carries per
particle the augmented Cholesky factors of ``prior + stats`` and of
``prior + stats + the reference's future`` (:mod:`~bipk_tpu_torch.ops.
cholup`) and keeps them by rank-1 updates and downdates in place of the
three factorizations per GP and step: the look-ahead mean and the draw
project from views of the factor (the projection kernel, four launches
per step with two GPs) and the ancestor weights read its diagonal. In
exact arithmetic it is the same sweep as the direct one, and it takes
the same :class:`CSMCDraws`.

Each step keeps every value on the device: the reference's ancestor is a
0-d device tensor, never read back. Random draws are inputs
(:class:`CSMCDraws`), so the tests can feed the JAX package's draws.

The direct step is one body for one device and for a particle mesh: it
takes the operations that differ (the softmax, the resampling, the
reference's categorical, the move of the particles to their ancestors,
the sum over ranks, and whether this sweep holds the pinned slot) from
``ops``, the sweep itself on one device and a
:class:`~bipk_tpu_torch.parallel.sharded_csmc.ShardedCSMC` on a mesh.
``build_csmc(mesh=)`` builds that sharded sweep: PyTorch has no GSPMD, and
the JAX package's GSPMD sweep samples the same posterior.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from bipk_tpu_torch._device import resolve_device
from bipk_tpu_torch.algorithms.apf import APFKernel, as_tensor
from bipk_tpu_torch.models.ssm import GPNode, SSM
from bipk_tpu_torch.ops import cholup, mniw, resampling
from bipk_tpu_torch.ops.gaussian import mvn_logpdf_chol


class CSMCResult(NamedTuple):
    state_traj: torch.Tensor  # (T, dx)
    int_var_traj: tuple  # each (T, n_i)
    ess: torch.Tensor  # (T-1,)
    log_weights: torch.Tensor  # (N,) final


class CSMCDraws(NamedTuple):
    """The random numbers one cSMC step consumes."""

    u_res: torch.Tensor  # (1,) systematic-resampling offset
    u_ref: torch.Tensor  # (1,) the reference ancestor's uniform
    z: torch.Tensor  # (dx, N) process-noise normals
    uvs: tuple  # per GP, (u, v) uniforms (n_i, N) of the matrix-t draw


class CSMCTrace(NamedTuple):
    """Batch-last traces of one sweep."""

    states: torch.Tensor  # (T, dx, N)
    int_vars: tuple  # each (T, n_i, N)
    ancestors: torch.Tensor  # (T-1, N) int32, the reference's patched in
    ess: torch.Tensor  # (T-1,)
    final_log_weights: torch.Tensor  # (N,)


def ref_contributions(gps, ref_state, ref_int_vars, inputs) -> tuple:
    """Rank-1 statistics of the reference at every time point: per GP an
    MNIW with leaves ``(T, m, n)``, ``(T, m, m)``, ``(T, n, n)``, ``(T,)``.
    ``ref_state (T, dx)``, ``ref_int_vars`` each ``(T, n_i)``, ``inputs
    (T, du)``; the basis is evaluated for all time points in one call,
    one input column per time point."""
    out = []
    for gp, iv in zip(gps, ref_int_vars):
        phi = gp.basis_fn_bl(ref_state.T, inputs.T)
        st = mniw.suff_stat_bl(iv.reshape(iv.shape[0], -1).T, phi)
        out.append(mniw.MNIW(*(leaf.movedim(-1, 0) for leaf in st)))
    return tuple(out)


def _at(stats: tuple, t: int) -> tuple:
    """Time point ``t`` of :func:`ref_contributions`."""
    return tuple(mniw.MNIW(*(leaf[t] for leaf in st)) for st in stats)


class CSMC:
    """The conditional SMC sweep with ancestor sampling on one device.

    Call it as ``csmc(generator, observations, inputs, init_state_mean,
    init_state_cov, ref_state, ref_int_vars, ref_summed_stats)``;
    :meth:`init`, :meth:`pin_initial`, :meth:`draws` and :meth:`step`
    expose the pieces with injected draws.
    """

    def __init__(self, kern: APFKernel, n_particles: int):
        self.kern = kern
        self.n_particles = n_particles
        if kern.process_chol is not None:
            self._q_logdet = torch.log(torch.diagonal(kern.process_chol)).sum()

    def draws(self, generator: torch.Generator) -> CSMCDraws:
        """A filter step's draws plus the reference ancestor's uniform."""
        k = self.kern
        d = k.step_draws(generator, self.n_particles)
        u_ref = torch.rand((1,), generator=generator, dtype=k.dtype, device=k.device)
        return CSMCDraws(d.u_res, u_ref, d.z, d.uvs)

    def pin_initial(self, particles, ref_x0, ref_iv0, ref_T0, ref_summed_stats, pin=True):
        """Pin the last initial particle to the reference at t = 0 and
        start the reference's future statistics (its summed statistics
        without t = 0). ``particles`` is ``APFKernel.init_particles``'
        carry, ``ref_T0`` the reference's contribution at t = 0 per GP;
        ``pin=False`` (a rank without the pinned slot) leaves the
        particles as they are. Returns the carry ``(log_weights, state,
        int_vars, Ss, ref_stats)``."""
        log_w0, state0, iv0, Ss0 = particles
        if pin:
            state0 = state0.clone()
            state0[:, -1] = ref_x0
            iv0 = tuple(iv.clone() for iv in iv0)
            Ss0 = tuple(S.clone() for S in Ss0)
            for i in range(self.kern.n_gp):
                iv0[i][:, -1] = ref_iv0[i]
                Ss0[i][:, -1] = mniw.pack_stats_bl(
                    mniw.MNIW(*(leaf[..., None] for leaf in ref_T0[i]))
                )[:, 0]
        ref_stats = tuple(
            mniw.MNIW(*(s - t for s, t in zip(ref_summed_stats[i], ref_T0[i])))
            for i in range(self.kern.n_gp)
        )
        return log_w0, state0, iv0, Ss0, ref_stats

    def init(self, generator, inputs0, init_mean, init_cov, ref_x0, ref_iv0,
             ref_T0, ref_summed_stats, pin=True):
        particles = self.kern.init_particles(
            generator, self.n_particles, inputs0, init_mean, init_cov
        )
        return self.pin_initial(particles, ref_x0, ref_iv0, ref_T0, ref_summed_stats, pin)

    def _transition_logpdf_to_ref(self, aux_state, ref_x):
        """Gaussian transition density from each look-ahead state to the
        reference state; zero for a deterministic transition."""
        if self.kern.process_chol is None:
            return torch.zeros_like(aux_state[0])
        return mvn_logpdf_chol(ref_x[:, None], aux_state, self.kern.process_chol,
                               log_det_chol=self._q_logdet)

    # -- the operations a step takes from ``ops``: one device's ------------

    holds_pinned = True  # the pinned particle is this sweep's last slot
    mesh = None  # one device

    @staticmethod
    def softmax(x):
        """The normalized weights of the log weights ``x``."""
        return torch.softmax(x, 0)

    @staticmethod
    def psum(x):
        """The sum of per-rank partials: on one device, ``x``."""
        return x

    def resample(self, w, u):
        """Sorted systematic ancestors of the weights ``w``: #2."""
        return self.kern.resample(w, u)

    @staticmethod
    def categorical(w, u):
        """The reference's ancestor: one inverse-CDF draw from ``w``."""
        return resampling.categorical_from_weights(w, u)

    def move(self, state, int_vars, ll_aux, Ss, ancestors):
        """The particles' small payloads at their ``ancestors`` (one
        gather); the statistics stay where they are, for the draw kernel's
        own gather (#4). Returns ``(state, int_vars, ll_aux, None)``."""
        state_g, *iv_g, ll_aux_g = self.kern.packed_gather([state, *int_vars, ll_aux],
                                                           ancestors)
        return state_g, tuple(iv_g), ll_aux_g, None

    # -- the step ----------------------------------------------------------

    def step(self, carry, obs, inp_prev, inp_cur, ref_x, ref_iv, ref_T,
             draws: CSMCDraws, ops=None):
        """One step; ``ref_x (dx,)``, ``ref_iv`` per GP ``(n_i,)`` and
        ``ref_T`` per GP the reference's contribution at this step;
        ``ops`` the sweep whose operations it takes (this one by
        default). Returns ``(carry, (ancestors, ess))`` with the
        reference's ancestor patched into ``ancestors``: :meth:`lookahead`,
        :meth:`select`, ``ops.move``, :meth:`advance`, :meth:`close`."""
        ops = self if ops is None else ops
        _, state, int_vars, Ss, ref_stats = carry
        lw_aux, ll_aux, lw_as, lws = self.lookahead(carry, obs, inp_prev, inp_cur, ref_x)
        ancestors_sorted, ancestors, ref_idx = self.select(lw_aux, lw_as, draws, ops)
        moved = ops.move(state, int_vars, ll_aux, Ss, ancestors)
        new = self.advance(moved, Ss, ancestors_sorted, ref_idx, obs, inp_prev, inp_cur,
                           ref_x, ref_iv, draws.z, draws.uvs, lws, ops.holds_pinned)
        return self.close(new, ref_stats, ref_T, ancestors, ops)

    def lookahead(self, carry, obs, inp_prev, inp_cur, ref_x):
        """A step's first phase on the particles of ``carry`` (all of them,
        or a chunk): the look-ahead (#1 per GP; with ``reuse_factor`` it
        also emits the factor of ``kern.priors + 1.0 * S``, which the draw
        reuses) and the reference's ancestor weights: the marginal
        likelihood without the reference's future statistics minus with
        them (prior + future folded into #5's prior), plus the transition
        density to the reference, on the time-(t-1) weights. Returns
        ``(lw_aux, ll_aux, lw_as, lws)``: the first-stage log weights, the
        look-ahead log-likelihoods, the ancestor log weights and the
        factors (None without ``reuse_factor``)."""
        kern = self.kern
        log_weights, state, int_vars, Ss, ref_stats = carry
        aux_state, _, lw_aux, ll_aux, fps, lws = kern.auxiliary_fused_packed_f(
            Ss, 1.0, state, int_vars, inp_prev, inp_cur, obs, log_weights,
            emit_factor=kern.reuse_factor,
        )
        g_diff = torch.zeros_like(lw_aux)
        for i in range(kern.n_gp):
            prior_eff = mniw.MNIW(*(p + r for p, r in zip(kern.priors[i], ref_stats[i])))
            with_future = kern.log_base_measure_packed(i, Ss[i], prior_eff)
            # the look-ahead's factor of prior + S, its df = T3 + prior T3
            fp = fps[i]._replace(df=kern.priors[i].T3 + Ss[i][-1])
            without_future = mniw.log_base_measure_from_projected_bl(fp, kern.ms[i])
            g_diff = g_diff + without_future - with_future
        h_x = self._transition_logpdf_to_ref(aux_state, ref_x)
        return lw_aux, ll_aux, log_weights + g_diff + h_x, lws

    @staticmethod
    def select(lw_aux, lw_as, draws: CSMCDraws, ops):
        """The resampling on the first-stage weights and the reference's
        ancestor on the ancestor weights, by ``ops``. Returns
        ``(ancestors_sorted, ancestors, ref_idx)``: ``ancestors`` is a copy
        of the sorted ones with ``ref_idx`` in the pinned slot."""
        ancestors_sorted = ops.resample(ops.softmax(lw_aux), draws.u_res)
        ref_idx = ops.categorical(ops.softmax(lw_as), draws.u_ref)
        ancestors = ancestors_sorted.clone()
        if ops.holds_pinned:
            ancestors[-1:] = ref_idx.view(1)
        return ancestors_sorted, ancestors, ref_idx

    def advance(self, moved, Ss, ancestors_sorted, ref_idx, obs, inp_prev, inp_cur,
                ref_x, ref_iv, z, uvs, lws, pin):
        """A step's second phase on the moved particles (all, or a chunk):
        the propagation, the matrix-t draw and rank-1 update, the pinned
        slot (the last, where ``pin``) and the new log weights. ``moved``
        is ``ops.move``'s result: where it holds no statistics (one
        device), #4 gathers them with the sorted, unpatched ancestors (or
        the opt-in kernels with ``lws`` / dedup); where it does (the
        statistics moved with the particles), #3 draws on them. The
        pinned column is its ancestor's statistics plus the reference's
        datum, written into the kernel's fresh output (never into
        ``Ss``). Returns ``(log_weights, state, int_vars, Ss)``."""
        kern = self.kern
        state_m, iv_m, ll_aux_m, Ss_m = moved
        new_state = kern.propagate_all(z, state_m, inp_prev, iv_m)
        if pin:
            new_state[:, -1] = ref_x
        if Ss_m is None:
            Ss_new, new_iv, new_basis, _ = kern.draw_update_gather_all_packed(
                uvs, Ss, ancestors_sorted, 1.0, new_state, inp_cur, factors=lws,
            )
        else:
            Ss_new, new_iv, new_basis, _ = kern.draw_update_all_packed(
                uvs, Ss_m, 1.0, new_state, inp_cur)
        if pin:
            for i in range(kern.n_gp):
                pinned = torch.atleast_1d(ref_iv[i])
                src = (Ss[i].index_select(1, ref_idx.view(1))[:, 0] if Ss_m is None
                       else Ss_m[i][:, -1])
                Ss_new[i][:, -1] = src + mniw.pack_suff_col(pinned, new_basis[i][:, -1])
                new_iv[i][:, -1] = pinned
        new_log_weights = kern.log_lik_all(obs, new_state, inp_cur, new_iv) - ll_aux_m
        return new_log_weights, new_state, new_iv, Ss_new

    def close(self, new, ref_stats, ref_T, ancestors, ops):
        """The step's end: the reference's contribution at this step leaves
        its future statistics, and the ESS of the new weights (a sum over
        ``ops``' ranks). Returns ``(carry, (ancestors, ess))``."""
        new_ref_stats = tuple(
            mniw.MNIW(*(s - t for s, t in zip(ref_stats[i], ref_T[i])))
            for i in range(self.kern.n_gp)
        )
        norm_w = ops.softmax(new[0])
        return (*new, new_ref_stats), (ancestors, 1.0 / ops.psum((norm_w * norm_w).sum()))

    def prepare(self, observations, inputs, ref_state, ref_int_vars, ref_summed_stats):
        """A sweep's data on the kernel's device: ``(obs (T, dy), inputs,
        ref_state, ref_ivs (each (T, n_i)), ref_summed, ref_T)``, ``ref_T``
        the reference's contributions (:func:`ref_contributions`)."""
        k = self.kern
        obs = as_tensor(observations, k.dtype, k.device)
        obs = obs.reshape(obs.shape[0], -1)
        inputs = as_tensor(inputs, k.dtype, k.device)
        ref_state = as_tensor(ref_state, k.dtype, k.device)
        ref_ivs = tuple(
            as_tensor(r, k.dtype, k.device).reshape(ref_state.shape[0], -1)
            for r in ref_int_vars
        )
        ref_summed = tuple(
            mniw.MNIW(*(as_tensor(leaf, k.dtype, k.device) for leaf in st))
            for st in ref_summed_stats
        )
        ref_T = ref_contributions(k.gps, ref_state, ref_ivs, inputs)
        return obs, inputs, ref_state, ref_ivs, ref_summed, ref_T

    def trace(
        self, generator, observations, inputs, init_state_mean,
        init_state_cov, ref_state, ref_int_vars, ref_summed_stats,
    ) -> CSMCTrace:
        """One sweep with its batch-last traces."""
        obs, inputs, ref_state, ref_ivs, ref_summed, ref_T = self.prepare(
            observations, inputs, ref_state, ref_int_vars, ref_summed_stats)
        carry = self.init(
            generator, inputs[0], init_state_mean, init_state_cov,
            ref_state[0], tuple(r[0] for r in ref_ivs), _at(ref_T, 0), ref_summed,
        )
        draws = (self.draws(generator) for _ in range(obs.shape[0] - 1))
        return self.run(carry, obs, inputs, ref_state, ref_ivs, ref_T, draws)

    def run(self, carry, obs, inputs, ref_state, ref_ivs, ref_T, draws,
            step=None) -> CSMCTrace:
        """The sweep from the pinned initial ``carry``, on tensors of the
        kernel's device: ``obs (T, dy)``, ``inputs (T, du)``, the reference
        ``ref_state (T, dx)`` and ``ref_ivs`` (each ``(T, n_i)``), its
        contributions ``ref_T`` (:func:`ref_contributions`), and one
        :class:`CSMCDraws` per step from the iterable ``draws``; ``step``
        (default :meth:`step`) takes each step."""
        k = self.kern
        step = self.step if step is None else step
        states, ivs, ancestors, ess = [carry[1]], [carry[2]], [], []
        for t, step_draws in zip(range(obs.shape[0] - 1), draws):
            carry, (anc, e) = step(
                carry, obs[t + 1], inputs[t], inputs[t + 1], ref_state[t + 1],
                tuple(r[t + 1] for r in ref_ivs), _at(ref_T, t + 1), step_draws,
            )
            states.append(carry[1])
            ivs.append(carry[2])
            ancestors.append(anc)
            ess.append(e)
        return CSMCTrace(
            torch.stack(states),
            tuple(torch.stack([iv[i] for iv in ivs]) for i in range(k.n_gp)),
            torch.stack(ancestors),
            torch.stack(ess),
            carry[0],
        )

    def result(self, tr: CSMCTrace, u) -> CSMCResult:
        """The sweep's result from its trace: one trajectory by backward
        ancestry from the final weights, drawn with the uniform ``u``."""
        idx = resampling.categorical_from_weights(
            torch.softmax(tr.final_log_weights, 0), u
        )
        (state_traj, iv_traj), _ = resampling.reconstruct_trajectory_bl(
            (tr.states, tr.int_vars), tr.ancestors, idx
        )
        return CSMCResult(state_traj, iv_traj, tr.ess, tr.final_log_weights)

    def __call__(
        self, generator, observations, inputs, init_state_mean,
        init_state_cov, ref_state, ref_int_vars, ref_summed_stats,
    ) -> CSMCResult:
        tr = self.trace(
            generator, observations, inputs, init_state_mean, init_state_cov,
            ref_state, ref_int_vars, ref_summed_stats,
        )
        u = torch.rand((1,), generator=generator, dtype=self.kern.dtype,
                       device=self.kern.device)
        return self.result(tr, u)


class CSMCRank1(CSMC):
    """The rank-1 factor-carry cSMC sweep (the JAX ``step_rank1`` and the
    rank-1 initialisation of ``run``). The carry is ``(log_weights,
    state, int_vars, Fs, dfs, Fps, dfps)``: per GP the augmented factor
    ``F (p, p, N)`` of ``prior + stats`` and ``Fp`` of ``prior + stats +
    future``, and their degrees of freedom ``(N,)``. Called, traced and
    run as :class:`CSMC`; the step ignores ``ref_T`` (the reference's
    datum enters as a vector, ``[phi(ref_x); ref_iv]``)."""

    def pin_initial(self, particles, ref_x0, ref_iv0, ref_T0, ref_summed_stats, pin=True):
        """:meth:`CSMC.pin_initial`, then the two augmented factors per GP
        of the pinned statistics (with the dtype's jitter, once)."""
        log_w0, state0, iv0, Ss0, ref_stats = super().pin_initial(
            particles, ref_x0, ref_iv0, ref_T0, ref_summed_stats, pin)
        kern = self.kern
        Fs, dfs, Fps, dfps = [], [], [], []
        for i in range(kern.n_gp):
            m, n = kern.ms[i], kern.ns[i]
            st = mniw.from_flat_bl(mniw.unpack_stats_bl(Ss0[i], m, n), m, n)
            prior = kern.priors[i]
            nat = mniw.MNIW(*(p[..., None] + s_ for p, s_ in zip(prior[:3], st[:3])),
                            prior.T3 + st.T3)
            nat_p = mniw.MNIW(*(a + r[..., None] for a, r in zip(nat[:3], ref_stats[i][:3])),
                              nat.T3 + ref_stats[i].T3)
            for out, df_out, nat_ in ((Fs, dfs, nat), (Fps, dfps, nat_p)):
                F, df = cholup.aug_factorize_bl(nat_, jitter=kern.jitter)
                out.append(F)
                df_out.append(df)
        return log_w0, state0, iv0, tuple(Fs), tuple(dfs), tuple(Fps), tuple(dfps)

    def step(self, carry, obs, inp_prev, inp_cur, ref_x, ref_iv, ref_T,
             draws: CSMCDraws):
        """One rank-1 step on one device; the arguments (but ``ops``) and
        result of :meth:`CSMC.step`."""
        kern = self.kern
        n_gp, ms = kern.n_gp, kern.ms
        log_weights, state, int_vars, Fs, dfs, Fps, dfps = carry
        factors = tuple(cholup.aug_to_factor(Fs[i], dfs[i], ms[i]) for i in range(n_gp))
        aux_state, _, lw_aux, ll_aux = kern.auxiliary(
            state, int_vars, factors, inp_prev, inp_cur, obs, log_weights)
        ancestors = kern.resample(torch.softmax(lw_aux, 0), draws.u_res).clone()

        # ancestor weights straight off the carried factors' diagonals
        g_diff = torch.zeros_like(lw_aux)
        for i in range(n_gp):
            g_diff = (g_diff + cholup.aug_log_base_measure(Fs[i], dfs[i], ms[i])
                      - cholup.aug_log_base_measure(Fps[i], dfps[i], ms[i]))
        h_x = self._transition_logpdf_to_ref(aux_state, ref_x)
        ref_idx = resampling.categorical_from_weights(
            torch.softmax(log_weights + g_diff + h_x, 0), draws.u_ref
        )
        ancestors[-1:] = ref_idx.view(1)

        took = kern.packed_gather(
            [state, *int_vars, *Fs, *dfs, *Fps, *dfps, ll_aux], ancestors)
        state_g, ll_aux_g = took[0], took[-1]
        iv_g, F_g, df_g, Fp_g, dfp_g = (took[1 + k * n_gp:1 + (k + 1) * n_gp] for k in range(5))
        factors_res = tuple(cholup.aug_to_factor(F_g[i], df_g[i], ms[i]) for i in range(n_gp))
        new_state = kern.propagate_all(draws.z, state_g, inp_prev, iv_g)
        new_state[:, -1] = ref_x
        new_iv, new_basis = kern.draw_int_vars(draws.uvs, factors_res, new_state, inp_cur)
        for i in range(n_gp):
            new_iv[i][:, -1] = ref_iv[i]
        new_log_weights = kern.log_lik_all(obs, new_state, inp_cur, new_iv) - ll_aux_g

        # O(p^2) factor maintenance: each particle's datum [phi; y]; the
        # future factor also loses the reference's datum at this step
        zs = [torch.cat([new_basis[i], new_iv[i]], 0) for i in range(n_gp)]
        z_refs = [torch.cat([kern.basis_all(i, ref_x[:, None], inp_cur)[:, 0],
                             torch.atleast_1d(ref_iv[i])]) for i in range(n_gp)]
        new_Fs, new_Fps = _maintain_factors(F_g, Fp_g, zs, z_refs)
        new_dfs = tuple(d + 1.0 for d in df_g)  # dfps: +1 datum, -1 future
        norm_w = torch.softmax(new_log_weights, 0)
        carry = (new_log_weights, new_state, new_iv, new_Fs, new_dfs, new_Fps, tuple(dfp_g))
        return carry, (ancestors, 1.0 / (norm_w * norm_w).sum())


def _maintain_factors(Fs, Fps, zs, z_refs):
    """``(F + z z^T per GP, Fp - z_ref z_ref^T + z z^T per GP)`` in Cholesky
    form. The GPs are grouped by the order of their factors (the vehicle's
    two GPs form one group); per group the downdates run as one call and
    the updates as another, the factors side by side along the particle
    axis (each entry's arithmetic is that of its own call; eight launches
    per column and group instead of eight per column and factor)."""
    n_gp, N = len(Fs), Fs[0].shape[-1]
    new_Fs, new_Fps = [None] * n_gp, [None] * n_gp
    for order in sorted({F.shape[0] for F in Fs}):
        group = [i for i in range(n_gp) if Fs[i].shape[0] == order]
        down = cholup.chol_rank1_downdate_bl(
            torch.cat([Fps[i] for i in group], -1),
            torch.cat([z_refs[i][:, None].expand(-1, N) for i in group], -1))
        up = cholup.chol_rank1_update_bl(torch.cat([*(Fs[i] for i in group), down], -1),
                                         torch.cat([zs[i] for i in group] * 2, -1))
        parts = up.split(N, -1)
        for k, i in enumerate(group):
            new_Fs[i], new_Fps[i] = parts[k], parts[len(group) + k]
    return tuple(new_Fs), tuple(new_Fps)


def build_csmc(
    ssm: SSM,
    gps: Sequence[GPNode],
    n_particles: int,
    dtype=torch.float32,
    mesh=None,
    rank1: bool | None = None,
    device: str | torch.device | None = None,
    reference: bool = False,
    reuse_factor: bool = False,
    dedup_gather: bool = False,
):
    """Build the conditional-SMC-with-ancestor-sampling sweep on one
    device: the direct formulation, or with ``rank1=True`` the rank-1
    factor-carry one (:class:`CSMCRank1`; opt-in, as in the JAX package).

    ``device`` defaults to CUDA and raises if no card is present.
    ``reference=True`` runs the kernels' plain PyTorch versions in their
    place. ``reuse_factor`` and ``dedup_gather`` select the opt-in
    gather/draw kernels of the direct step (:class:`~bipk_tpu_torch.
    algorithms.apf.APFKernel`); the reused factor is that of the prior
    plus the statistics at lambda = 1, as the draw's. The rank-1 step
    carries no packed statistics and launches neither kernel, so
    ``rank1=True`` with either raises ``ValueError``; on the card without
    ``reference`` it raises unless the dtype is float32 and every GP has
    m <= 48 and n <= 2, as the direct step's kernels do.

    ``mesh`` (a :class:`~bipk_tpu_torch.parallel.mesh.ParticleMesh`) builds
    the particle-sharded sweep instead (:func:`~bipk_tpu_torch.parallel.
    sharded_csmc.build_sharded_csmc`, on the mesh's device; ``device``,
    if given, must be it): the JAX package's ``mesh=`` is GSPMD, which
    PyTorch does not have, and samples the same posterior. Its step is the
    direct one, so ``rank1=True`` with a mesh raises ``ValueError``;
    ``reuse_factor`` and ``dedup_gather`` do not apply there (its draw,
    #3, gathers nothing, and its look-ahead emits no factor).
    """
    if rank1 and (reuse_factor or dedup_gather):
        raise ValueError("rank1=True carries augmented factors, not packed statistics: "
                         "reuse_factor and dedup_gather select kernels it never launches")
    if mesh is not None:
        if rank1:
            raise ValueError("rank1=True is a single-device sweep: the sharded cSMC "
                             "(mesh=) runs the direct step")
        from bipk_tpu_torch.parallel.sharded_csmc import build_sharded_csmc

        return build_sharded_csmc(ssm, gps, n_particles, mesh, dtype=dtype, device=device,
                                  reference=reference)
    device = resolve_device("cuda" if device is None else device)
    kern = APFKernel(ssm, gps, dtype, device, reference=reference,
                     reuse_factor=reuse_factor, dedup_gather=dedup_gather)
    if rank1:
        # the step's one kernel, the projection: on the card it takes what
        # the mniw entry points take (float32, m <= 48, n <= 2) or raises
        for i in range(kern.n_gp):
            mniw.kernels_take("build_csmc(rank1=True)", kern.priors[i].T1, kern.ms[i],
                               kern.ns[i], reference)
    return (CSMCRank1 if rank1 else CSMC)(kern, n_particles)
