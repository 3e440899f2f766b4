"""Algorithm 1: the online auxiliary particle filter with per-particle
MNIW statistics (port of ``bipk_tpu/algorithms/apf.py``: ``APFKernel``,
its packed and unpacked building blocks, and ``build_apf``).

Every per-particle tensor is batch-last: ``state (dx, N)``, interface
variables ``(n_i, N)``, one packed statistics matrix ``(rows, N)`` per GP
on the sweeps' path; the unpacked methods take structured or flat MNIW
leaves or factors, as the rank-1 cSMC and the JAX package's unpacked
entry points do.
Random draws are inputs (standard normals ``z``, uniforms ``u, v``), so
each method is a deterministic function that the tests can feed with the
JAX package's draws.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from bipk_tpu_torch._device import resolve_device
from bipk_tpu_torch.models.ssm import GPNode, SSM
from bipk_tpu_torch.ops import cuda_kernels as ck
from bipk_tpu_torch.ops import mniw
from bipk_tpu_torch.ops.gaussian import mvn_logpdf_chol


class StepDraws(NamedTuple):
    """The random numbers one filter step consumes."""

    u_res: torch.Tensor  # (1,) systematic-resampling offset
    z: torch.Tensor | None  # (dx, N) process-noise normals; None if deterministic
    uvs: tuple  # per GP, (u, v) uniforms (n_i, N) of the matrix-t draw


def as_tensor(x, dtype, device) -> torch.Tensor:
    """A tensor or an array (numpy, or anything ``np.array`` reads) as a
    tensor of ``dtype`` on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


class APFKernel:
    """Shared batch-last building blocks for APF-family sweeps.

    The three per-particle hot spots go through the CUDA kernel wrappers
    (:mod:`bipk_tpu_torch.ops.cuda_kernels`); ``reference=True`` calls
    their plain PyTorch versions instead, on any device, so a whole sweep
    can be held against the kernels. The unpacked methods go through the
    dispatching entry points of :mod:`~bipk_tpu_torch.ops.mniw` (the
    unpacked kernels on CUDA tensors: float32, m <= 48, n <= 2, else they
    raise), with ``plain=reference``.

    Two opt-in configurations of the gather/draw, for GPs with m <= 24
    (wider GPs keep the default kernels):

    - ``reuse_factor``: the look-ahead's kernel also emits the factor
      ``LW = [tril(L) | white]`` of ``prior + lam * S``, and the draw reads
      it instead of factoring the same statistics again (the JAX
      package's ``BIPK_REUSE_FACTOR=1``, ``bipk_tpu/algorithms/apf.py:
      82-92``);
    - ``dedup_gather``: the draw stages each block's distinct ancestor
      columns in shared memory (the JAX package's ``BIPK_DEDUP_GATHER=1``).

    With both, the factor wins, as in JAX. The port reads no environment
    variable: the keywords are the switch.
    """

    def __init__(
        self, ssm: SSM, gps: Sequence[GPNode], dtype, device,
        reference: bool = False, reuse_factor: bool = False,
        dedup_gather: bool = False,
    ):
        self.ssm = ssm
        self.gps = tuple(gps)
        self.n_gp = len(self.gps)
        self.dtype = dtype
        self.device = torch.device(device)
        self.priors = tuple(gp.prior_as(dtype, self.device) for gp in self.gps)
        self.prior_blocks = tuple((p.T0, p.T1, p.T2) for p in self.priors)
        # host floats: reading a device scalar per call would synchronise
        self.p3 = tuple(float(np.asarray(gp.prior.T3)) for gp in self.gps)
        self.ms = tuple(gp.basis_dim for gp in self.gps)
        self.ns = tuple(gp.out_dim for gp in self.gps)
        self.jitter = mniw._default_jitter(dtype)
        self.reference = reference
        self.reuse_factor = reuse_factor
        self.dedup_gather = dedup_gather
        self.process_chol = (
            None if ssm.is_deterministic else ssm.process_chol(dtype, self.device)
        )
        self.output_chol = ssm.output_chol(dtype, self.device)
        self._out_logdet = torch.log(torch.diagonal(self.output_chol)).sum()

        def pick(wrapper):
            return ck.PLAIN[wrapper] if reference else wrapper

        self._factorize_project = pick(ck.factorize_project_packed)
        self._systematic = pick(ck.systematic_ancestors_blocks)
        self._logdets = pick(ck.log_base_measure_packed_logdets)
        self._draw_update = pick(ck.draw_update_packed_blocks)

    # -- model evaluation ------------------------------------------------

    def transition_all(self, state, inp, int_vars):
        return self.ssm.transition(state, inp, *int_vars)

    def output_all(self, state, inp, int_vars):
        """Model outputs ``(dy, N)``; an output that returns ``(N,)`` (one
        measured state) gets its leading axis back."""
        return self.ssm.output(state, inp, *int_vars).reshape(-1, state.shape[-1])

    def basis_all(self, i, state, inp):
        return self.gps[i].basis_fn_bl(state, inp)

    def log_lik_all(self, obs, state, inp, int_vars):
        """Gaussian observation log density per particle ``(N,)``."""
        return mvn_logpdf_chol(obs[:, None], self.output_all(state, inp, int_vars),
                               self.output_chol, log_det_chol=self._out_logdet)

    def trace_outputs(self, obs, inputs, states, int_vars):
        """Model outputs and observation log densities at every entry of
        batch-last traces: ``obs (T, dy)``, ``inputs (T, du)``, ``states
        (T, dx, M)``, ``int_vars`` each ``(T, n_i, M)`` -> ``(outputs (T, M,
        dy), log_lik (T, M))``, in one batched call with the inputs and
        observations repeated per column."""
        T, M = states.shape[0], states.shape[-1]

        def cols(x):  # (T, d, M) -> (d, T*M), time-major columns
            return x.permute(1, 0, 2).reshape(x.shape[1], T * M)

        out = self.output_all(
            cols(states), inputs.T.repeat_interleave(M, 1),
            tuple(cols(iv) for iv in int_vars),
        )
        ll = mvn_logpdf_chol(obs.T.repeat_interleave(M, 1), out, self.output_chol)
        return out.reshape(-1, T, M).permute(1, 2, 0), ll.reshape(T, M)

    def propagate_all(self, z, state, inp, int_vars):
        """Transition plus Gaussian process noise ``chol(Q) z``; a
        deterministic transition takes no noise (``z`` is None)."""
        nxt = self.transition_all(state, inp, int_vars)
        if self.process_chol is None:
            return nxt
        return nxt + self.process_chol @ z

    # -- draws and init --------------------------------------------------

    def step_draws(self, generator, n_particles) -> StepDraws:
        """One filter step's draws from ``generator``: the resampling
        offset, the process noise (none for a deterministic transition),
        each GP's matrix-t uniforms."""
        opts = dict(generator=generator, dtype=self.dtype, device=self.device)
        u_res = torch.rand((1,), **opts)
        z = None if self.process_chol is None else torch.randn(
            (self.ssm.state_dim, n_particles), **opts)
        uvs = tuple(
            (torch.rand((n, n_particles), **opts),
             torch.rand((n, n_particles), **opts))
            for n in self.ns
        )
        return StepDraws(u_res, z, uvs)

    def init_particles(self, generator, n_particles, inputs0, init_mean, init_cov):
        """Initial ``(log_weights, state, int_vars, Ss)``: Gaussian states
        and interface variables, rank-1 statistics, packed per GP."""
        mean = torch.as_tensor(init_mean, dtype=self.dtype, device=self.device)
        chol = torch.linalg.cholesky(
            torch.as_tensor(np.atleast_2d(init_cov), dtype=self.dtype, device=self.device)
        )
        z = torch.randn((mean.shape[0], n_particles), generator=generator,
                        dtype=self.dtype, device=self.device)
        state = mean[:, None] + chol @ z
        int_vars = []
        for gp in self.gps:
            gmean = torch.as_tensor(np.atleast_1d(gp.init_mean), dtype=self.dtype,
                                    device=self.device)
            z = torch.randn((gmean.shape[0], n_particles), generator=generator,
                            dtype=self.dtype, device=self.device)
            int_vars.append(gmean[:, None] + gp.init_chol(self.dtype, self.device) @ z)
        int_vars = tuple(int_vars)
        Ss = tuple(
            mniw.pack_stats_bl(
                mniw.suff_stat_bl(int_vars[i], self.basis_all(i, state, inputs0))
            )
            for i in range(self.n_gp)
        )
        log_weights = torch.zeros((n_particles,), dtype=self.dtype, device=self.device)
        return log_weights, state, int_vars, Ss

    # -- packed-statistics pieces ------------------------------------------

    def projected_all_packed(self, Ss, lam, basis, emit_factor=False):
        """Per-GP fused factorization + predictive projection over the
        packed carry: one :class:`~bipk_tpu_torch.ops.mniw.ProjectedFactor`
        per GP. Its ``df`` is None: the filter never reads it, and the
        cSMC, which does, fills it in. With ``emit_factor`` returns ``(fps,
        lws)``, ``lws`` each GP's packed factor ``[tril(L) | white]``, or
        None for a GP wider than ``mniw.FACTOR_MAX_M``."""
        fps, lws = [], []
        for i in range(self.n_gp):
            emit = emit_factor and self.ms[i] <= mniw.FACTOR_MAX_M
            out = self._factorize_project(
                Ss[i], basis[i], self.jitter, lam, self.prior_blocks[i],
                m=self.ms[i], n=self.ns[i], emit_factor=emit,
            )
            fps.append(mniw.ProjectedFactor(*out[:5], None))
            lws.append(out[5] if emit else None)
        return (tuple(fps), tuple(lws)) if emit_factor else tuple(fps)

    def log_base_measure_packed(self, i, S, prior_eff):
        """GP ``i``'s MNIW log base measure of ``prior_eff + S`` per
        particle, the log-determinants from the kernel (``prior_eff``
        unbatched, e.g. the prior plus the cSMC reference's future
        statistics)."""
        return mniw.log_base_measure_packed_bl(
            S, prior_eff, self.ms[i], self.ns[i], jitter=self.jitter,
            logdets=self._logdets,
        )

    def auxiliary_fused_packed_f(
        self, Ss, lam, state, int_vars, inp_prev, inp_cur, obs, log_weights,
        emit_factor=True,
    ):
        """Look-ahead states and first-stage weights, the GP posterior mean
        at the look-ahead state projected in the factorization kernel, and
        with ``emit_factor`` each GP's packed factor for
        :meth:`draw_update_gather_all_packed` to reuse instead of factoring
        the same statistics again. Returns ``(aux_state, aux_iv, lw_aux,
        ll_aux, fps, lws)``, ``lws`` all None without ``emit_factor``."""
        aux_state = self.transition_all(state, inp_prev, int_vars)
        basis = tuple(
            self.basis_all(i, aux_state, inp_cur) for i in range(self.n_gp)
        )
        if emit_factor:
            fps, lws = self.projected_all_packed(Ss, lam, basis, emit_factor=True)
        else:
            fps, lws = self.projected_all_packed(Ss, lam, basis), (None,) * self.n_gp
        aux_iv = tuple(fp.mean for fp in fps)
        ll_aux = self.log_lik_all(obs, aux_state, inp_cur, aux_iv)
        return aux_state, aux_iv, ll_aux + log_weights, ll_aux, fps, lws

    def resample(self, weights, u):
        """Sorted systematic ancestors ``(N,)`` int32 for weights ``(N,)``."""
        return self._systematic(weights, u, weights.shape[0])

    def draw_update_gather_all_packed(
        self, uvs, Ss, ancestors, lam, new_state, inp_cur, factors=None,
    ):
        """Resampling gather + matrix-t draw + rank-1 statistics update per
        GP, the gather done inside the kernel. ``uvs`` holds each GP's
        ``(u, v)`` uniforms ``(n_i, N)``; ``factors`` (from
        :meth:`auxiliary_fused_packed_f`, the same ``Ss`` and ``lam``) lets
        the kernel reuse the look-ahead's factors. The kernel per GP is
        ``mniw.draw_update_gather_packed_bl``'s choice. Returns ``(Ss_new,
        new_iv, new_basis, lds)``."""
        new_basis = tuple(
            self.basis_all(i, new_state, inp_cur) for i in range(self.n_gp)
        )
        outs = tuple(
            mniw.draw_update_gather_packed_bl(
                uvs[i][0], uvs[i][1], Ss[i], ancestors, new_basis[i],
                prior=mniw.MNIW(*self.prior_blocks[i], self.p3[i]), lam=lam,
                m=self.ms[i], n=self.ns[i], jitter=self.jitter,
                factor=None if factors is None else factors[i],
                dedup=self.dedup_gather, plain=self.reference,
            )
            for i in range(self.n_gp)
        )
        Ss_new = tuple(o[0] for o in outs)
        new_iv = tuple(o[1] for o in outs)
        lds = tuple((o[2], o[3]) for o in outs)
        return Ss_new, new_iv, new_basis, lds

    # -- unpacked pieces: structured or flat MNIW leaves, or factors -------

    def factorize_all(self, stats, lam: float = 1.0):
        """Factor ``prior + lam * stats`` per GP (structured leaves), the
        scale and the prior folded into the kernel."""
        return tuple(
            mniw.factorize_scaled_bl(stats[i], prior=self.priors[i], lam=lam,
                                     jitter=self.jitter, plain=self.reference)
            for i in range(self.n_gp)
        )

    def auxiliary(self, state, int_vars, factors, inp_prev, inp_cur, obs, log_weights):
        """Look-ahead states and first-stage weights from given factors:
        each GP's posterior mean at the look-ahead state. Returns
        ``(aux_state, aux_iv, lw_aux, ll_aux)``."""
        aux_state = self.transition_all(state, inp_prev, int_vars)
        aux_iv = tuple(
            mniw.factor_mean_at_bl(factors[i], self.basis_all(i, aux_state, inp_cur),
                                   plain=self.reference)
            for i in range(self.n_gp)
        )
        ll_aux = self.log_lik_all(obs, aux_state, inp_cur, aux_iv)
        return aux_state, aux_iv, ll_aux + log_weights, ll_aux

    def projected_all(self, stats, lam, basis):
        """Per-GP factorization of ``prior + lam * stats`` (structured or
        flat) projected at ``basis``: one ``ProjectedFactor`` per GP."""
        return tuple(
            mniw.factorize_project_bl(stats[i], basis[i], prior=self.priors[i], lam=lam,
                                      jitter=self.jitter, plain=self.reference)
            for i in range(self.n_gp)
        )

    def auxiliary_fused(self, stats, lam, state, int_vars, inp_prev, inp_cur, obs,
                        log_weights):
        """:meth:`auxiliary` with the projection fused into the
        factorization: returns ``(aux_state, aux_iv, lw_aux, ll_aux,
        fps)``, ``fps`` per GP the ``ProjectedFactor`` (its
        log-determinants feed the cSMC's ancestor weights)."""
        aux_state = self.transition_all(state, inp_prev, int_vars)
        basis = tuple(self.basis_all(i, aux_state, inp_cur) for i in range(self.n_gp))
        fps = self.projected_all(stats, lam, basis)
        aux_iv = tuple(fp.mean for fp in fps)
        ll_aux = self.log_lik_all(obs, aux_state, inp_cur, aux_iv)
        return aux_state, aux_iv, ll_aux + log_weights, ll_aux, fps

    def draw_int_vars_fused(self, uvs, stats_g, lam, new_state, inp_cur):
        """Matrix-t draws of the interface variables, the factorization of
        the (gathered) statistics fused with the projection; ``uvs`` per
        GP the uniforms ``(u, v)``. Returns ``(new_iv, new_basis)``."""
        new_basis = tuple(self.basis_all(i, new_state, inp_cur) for i in range(self.n_gp))
        fps = self.projected_all(stats_g, lam, new_basis)
        new_iv = tuple(mniw.sample_projected_bl(fps[i], *uvs[i]) for i in range(self.n_gp))
        return new_iv, new_basis

    def draw_int_vars(self, uvs, factors_res, new_state, inp_cur):
        """Matrix-t draws of the interface variables from given
        (resampled) factors; returns ``(new_iv, new_basis)``."""
        new_basis = tuple(self.basis_all(i, new_state, inp_cur) for i in range(self.n_gp))
        new_iv = tuple(
            mniw.sample_predictive_bl(factors_res[i], new_basis[i], *uvs[i], plain=self.reference)
            for i in range(self.n_gp)
        )
        return new_iv, new_basis

    def update_stats(self, stats_res, new_iv, new_basis, lam: float = 1.0):
        """Rank-1 statistics update ``lam * stats + suff(y, phi)`` per GP,
        structured or flat leaves."""
        suff = mniw.suff_stat_flat_bl if stats_res[0].T1.dim() == 2 else mniw.suff_stat_bl
        out = []
        for i in range(self.n_gp):
            d = suff(new_iv[i], new_basis[i])
            if lam == 1.0:
                out.append(mniw.MNIW(*(s + d_ for s, d_ in zip(stats_res[i], d))))
            else:
                out.append(mniw.MNIW(*(s * lam + d_ for s, d_ in zip(stats_res[i], d))))
        return tuple(out)

    def draw_update_all_packed(self, uvs, Ss_g, lam, new_state, inp_cur):
        """Matrix-t draw + rank-1 update per GP over already-gathered
        packed statistics (the draw/update kernel, PERF.md row 3). Returns
        ``(Ss_new, new_iv, new_basis, lds)``."""
        new_basis = tuple(self.basis_all(i, new_state, inp_cur) for i in range(self.n_gp))
        outs = tuple(
            self._draw_update(Ss_g[i], new_basis[i], *uvs[i], self.jitter, lam,
                              self.prior_blocks[i], self.p3[i], m=self.ms[i], n=self.ns[i])
            for i in range(self.n_gp)
        )
        return (tuple(o[0] for o in outs), tuple(o[1] for o in outs), new_basis,
                tuple((o[2], o[3]) for o in outs))

    @staticmethod
    def gather(tensors, idx):
        """Resampling gather along the particle (last) axis of each tensor
        of a sequence (an MNIW too), one gather per tensor; returns the
        same kind of sequence."""
        out = [t.reshape(-1, t.shape[-1]).index_select(1, idx).reshape(t.shape[:-1] + idx.shape)
               for t in tensors]
        return type(tensors)(*out) if hasattr(tensors, "_fields") else type(tensors)(out)

    @staticmethod
    def gather_packed(Ss, idx):
        """Resampling gather of the packed statistics, one per GP."""
        return tuple(S.index_select(1, idx) for S in Ss)

    @staticmethod
    def packed_gather(tensors, idx):
        """Resampling gather of a list of batch-last tensors with ONE
        gather: rows are concatenated, gathered, and split back."""
        n = tensors[0].shape[-1]
        rows = [t.reshape(-1, n) for t in tensors]
        took = torch.cat(rows, 0).index_select(1, idx)
        parts = torch.split(took, [r.shape[0] for r in rows], 0)
        return [p.reshape(t.shape[:-1] + idx.shape) for p, t in zip(parts, tensors)]

    def weighted_stats_packed(self, Ss, weights):
        """Importance-weighted packed statistics ``(rows,)`` per GP."""
        return tuple(S @ weights for S in Ss)


class APFResult(NamedTuple):
    """Full-trace result of :func:`build_apf`, the JAX ``APFResult``'s
    fields and layouts."""

    states: torch.Tensor  # (T, N, dx)
    int_vars: tuple  # each (T, N, n_i)
    stats_mean: tuple  # each MNIW with leading (T, ...), weighted means
    weights: torch.Tensor  # (T, N) normalized
    ancestors: torch.Tensor  # (T-1, N) int32
    final_stats: tuple  # each MNIW with leading (N, ...)
    outputs: torch.Tensor  # (T, N, dy)
    log_likelihood: torch.Tensor  # (T, N)
    ess: torch.Tensor  # (T,)


class APF:
    """The online APF sweep with full traces (the JAX ``build_apf``). Call
    it as ``apf(generator, observations, inputs, init_state_mean,
    init_state_cov)``; :meth:`init`, :meth:`step` and ``kern.step_draws``
    expose one step with injected draws."""

    def __init__(self, kern: APFKernel, n_particles: int, forgetting_factor: float):
        self.kern = kern
        self.n_particles = n_particles
        self.lam = forgetting_factor

    def init(self, generator, inputs0, init_mean, init_cov):
        """Initial carry ``(log_weights, state, int_vars, Ss)``."""
        return self.kern.init_particles(
            generator, self.n_particles, inputs0, init_mean, init_cov
        )

    def step(self, carry, obs, inp_prev, inp_cur, draws: StepDraws):
        """One filter step; returns ``(carry, ancestors)``."""
        kern, lam = self.kern, self.lam
        log_weights, state, int_vars, Ss = carry
        _, _, lw_aux, ll_aux, _, lws = kern.auxiliary_fused_packed_f(
            Ss, lam, state, int_vars, inp_prev, inp_cur, obs, log_weights,
            emit_factor=kern.reuse_factor,
        )
        ancestors = kern.resample(torch.softmax(lw_aux, 0), draws.u_res)
        state_g, *iv_g, ll_aux_g = kern.packed_gather(
            [state, *int_vars, ll_aux], ancestors
        )
        new_state = kern.propagate_all(draws.z, state_g, inp_prev, iv_g)
        Ss_new, new_iv, _, _ = kern.draw_update_gather_all_packed(
            draws.uvs, Ss, ancestors, lam, new_state, inp_cur, factors=lws,
        )
        new_log_weights = kern.log_lik_all(obs, new_state, inp_cur, new_iv) - ll_aux_g
        return (new_log_weights, new_state, new_iv, Ss_new), ancestors

    def __call__(
        self, generator: torch.Generator, observations, inputs,
        init_state_mean, init_state_cov,
    ) -> APFResult:
        kern = self.kern
        obs = as_tensor(observations, kern.dtype, kern.device)
        obs = obs.reshape(obs.shape[0], -1)
        inputs = as_tensor(inputs, kern.dtype, kern.device)
        carry = self.init(generator, inputs[0], init_state_mean, init_state_cov)
        draws = (kern.step_draws(generator, self.n_particles)
                 for _ in range(obs.shape[0] - 1))
        return self.run(carry, obs, inputs, draws)

    def run(self, carry, obs, inputs, draws) -> APFResult:
        """The sweep from the initial ``carry`` over ``obs (T, dy)`` and
        ``inputs (T, du)`` (tensors on the kernel's device), taking one
        :class:`StepDraws` per step from the iterable ``draws``."""
        kern = self.kern
        log_ws, states, ivs, ancestors, reduced, ess = [], [], [], [], [], []

        def keep(carry):
            w = torch.softmax(carry[0], 0)
            log_ws.append(carry[0])
            states.append(carry[1])
            ivs.append(carry[2])
            reduced.append(kern.weighted_stats_packed(carry[3], w))
            ess.append(1.0 / (w * w).sum())

        keep(carry)
        for t, step_draws in zip(range(obs.shape[0] - 1), draws):
            carry, anc = self.step(carry, obs[t + 1], inputs[t], inputs[t + 1], step_draws)
            keep(carry)
            ancestors.append(anc)
        states = torch.stack(states)
        ivs = tuple(torch.stack([iv[i] for iv in ivs]) for i in range(kern.n_gp))
        outputs, log_lik = kern.trace_outputs(obs, inputs, states, ivs)
        final_stats = tuple(
            mniw.MNIW(*(leaf.movedim(-1, 0) for leaf in mniw.from_flat_bl(
                mniw.unpack_stats_bl(S, kern.ms[i], kern.ns[i]), kern.ms[i], kern.ns[i],
            )))
            for i, S in enumerate(carry[3])
        )
        return APFResult(
            states=states.transpose(1, 2),
            int_vars=tuple(iv.transpose(1, 2) for iv in ivs),
            stats_mean=tuple(
                mniw.unpack_reduced(torch.stack([r[i] for r in reduced]),
                                    kern.ms[i], kern.ns[i])
                for i in range(kern.n_gp)
            ),
            weights=torch.softmax(torch.stack(log_ws), 1),
            ancestors=torch.stack(ancestors),
            final_stats=final_stats,
            outputs=outputs,
            log_likelihood=log_lik,
            ess=torch.stack(ess),
        )


def build_apf(
    ssm: SSM,
    gps: Sequence[GPNode],
    n_particles: int,
    forgetting_factor: float = 1.0,
    dtype=torch.float32,
    device: str | torch.device = "cuda",
    reference: bool = False,
    reuse_factor: bool = False,
    dedup_gather: bool = False,
) -> APF:
    """Build the online APF sweep with full traces on one device (the
    JAX package's GSPMD ``mesh=`` is not ported). ``device`` defaults to
    CUDA and raises if no card is present. ``reference=True`` runs the
    kernels' plain PyTorch versions in their place (on any device), to
    hold a sweep against the kernels. ``reuse_factor`` and
    ``dedup_gather`` select the opt-in gather/draw kernels
    (:class:`APFKernel`)."""
    device = resolve_device(device)
    kern = APFKernel(ssm, gps, dtype, device, reference=reference,
                     reuse_factor=reuse_factor, dedup_gather=dedup_gather)
    return APF(kern, n_particles, forgetting_factor)


# -- batch-first helpers kept for reference-style baselines and tests -------


def init_particles(
    generator: torch.Generator, ssm: SSM, gps: Sequence[GPNode], n_particles: int,
    inputs0, init_state_mean, init_state_cov, dtype=torch.float32,
    device: str | torch.device = "cuda",
):
    """Batch-first initial particles: ``(log_weights (N,), state (N, dx),
    int_vars each (N, n_i), stats)``, each GP's statistics an MNIW with
    leaves ``(N, m, n)``, ``(N, m, m)``, ``(N, n, n)``, ``(N,)``; drawn as
    :meth:`APFKernel.init_particles` draws them."""
    kern = APFKernel(ssm, gps, dtype, resolve_device(device))
    inputs0 = as_tensor(inputs0, dtype, kern.device)
    log_w, state, int_vars, Ss = kern.init_particles(
        generator, n_particles, inputs0, init_state_mean, init_state_cov)
    stats = tuple(
        mniw.MNIW(*(leaf.movedim(-1, 0) for leaf in mniw.from_flat_bl(
            mniw.unpack_stats_bl(S, kern.ms[i], kern.ns[i]), kern.ms[i], kern.ns[i])))
        for i, S in enumerate(Ss)
    )
    return log_w, state.T, tuple(iv.T for iv in int_vars), stats


def weighted_stats(stats: tuple, weights: torch.Tensor) -> tuple:
    """Batch-first importance-weighted statistics mean: each GP's MNIW
    leaves ``(N, ...)`` contracted with ``weights (N,)``."""
    return tuple(
        mniw.MNIW(*(torch.tensordot(weights, leaf, dims=1) for leaf in st)) for st in stats
    )
