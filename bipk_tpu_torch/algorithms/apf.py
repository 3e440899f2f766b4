"""Algorithm 1 building blocks: the online auxiliary particle filter with
per-particle MNIW statistics (port of the packed-path subset of
``bipk_tpu/algorithms/apf.py`` ``APFKernel``).

Every per-particle tensor is batch-last: ``state (dx, N)``, interface
variables ``(n_i, N)``, one packed statistics matrix ``(rows, N)`` per GP.
Random draws are inputs (standard normals ``z``, uniforms ``u, v``), so
each method is a deterministic function that the tests can feed with the
JAX package's draws.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from bipk_tpu_torch.models.ssm import GPNode, SSM
from bipk_tpu_torch.ops import batched_linalg as bla
from bipk_tpu_torch.ops import cuda_kernels as ck
from bipk_tpu_torch.ops import mniw


class APFKernel:
    """Shared batch-last building blocks for APF-family sweeps.

    The three per-particle hot spots go through the CUDA kernel wrappers
    (:mod:`bipk_tpu_torch.ops.cuda_kernels`); ``reference=True`` calls
    their plain PyTorch versions instead, on any device, so a whole sweep
    can be held against the kernels.
    """

    def __init__(
        self, ssm: SSM, gps: Sequence[GPNode], dtype, device,
        reference: bool = False,
    ):
        self.ssm = ssm
        self.gps = tuple(gps)
        self.n_gp = len(self.gps)
        self.dtype = dtype
        self.device = torch.device(device)
        priors = tuple(gp.prior_as(dtype, self.device) for gp in self.gps)
        self.prior_blocks = tuple((p.T0, p.T1, p.T2) for p in priors)
        # host floats: reading a device scalar per call would synchronise
        self.p3 = tuple(float(np.asarray(gp.prior.T3)) for gp in self.gps)
        self.ms = tuple(gp.basis_dim for gp in self.gps)
        self.ns = tuple(gp.out_dim for gp in self.gps)
        self.jitter = mniw._default_jitter(dtype)
        self.process_chol = (
            None if ssm.is_deterministic else ssm.process_chol(dtype, self.device)
        )
        self.output_chol = ssm.output_chol(dtype, self.device)
        self._out_logdet = torch.log(torch.diagonal(self.output_chol)).sum()

        def pick(wrapper):
            return ck.PLAIN[wrapper] if reference else wrapper

        self._factorize_project = pick(ck.factorize_project_packed)
        self._systematic = pick(ck.systematic_ancestors_blocks)
        self._draw_update_gather = pick(ck.draw_update_gather_packed_blocks)

    # -- model evaluation ------------------------------------------------

    def transition_all(self, state, inp, int_vars):
        return self.ssm.transition(state, inp, *int_vars)

    def output_all(self, state, inp, int_vars):
        return self.ssm.output(state, inp, *int_vars)

    def basis_all(self, i, state, inp):
        return self.gps[i].basis_fn_bl(state, inp)

    def log_lik_all(self, obs, state, inp, int_vars):
        """Gaussian observation log density per particle ``(N,)``."""
        resid = self.output_all(state, inp, int_vars) - obs[:, None]
        white = bla.solve_lower_bl(self.output_chol, resid)
        dy = white.shape[0]
        quad = (white * white).sum(0)
        return -0.5 * (dy * math.log(2.0 * math.pi) + quad) - self._out_logdet

    def propagate_all(self, z, state, inp, int_vars):
        """Transition plus Gaussian process noise ``chol(Q) z``."""
        nxt = self.transition_all(state, inp, int_vars)
        if self.process_chol is None:
            return nxt
        return nxt + self.process_chol @ z

    # -- init ------------------------------------------------------------

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

    def projected_all_packed(self, Ss, lam, basis):
        """Per-GP fused factorization + predictive projection over the
        packed carry: ``(mean, col, row, logdet_T1, logdet_Psi)`` each."""
        return tuple(
            self._factorize_project(
                Ss[i], basis[i], self.jitter, lam, self.prior_blocks[i],
                m=self.ms[i], n=self.ns[i],
            )
            for i in range(self.n_gp)
        )

    def auxiliary_fused_packed(
        self, Ss, lam, state, int_vars, inp_prev, inp_cur, obs, log_weights,
    ):
        """Look-ahead states and first-stage weights, the GP posterior mean
        at the look-ahead state projected in the factorization kernel.
        Returns ``(aux_state, aux_iv, lw_aux, ll_aux, fps)``."""
        aux_state = self.transition_all(state, inp_prev, int_vars)
        basis = tuple(
            self.basis_all(i, aux_state, inp_cur) for i in range(self.n_gp)
        )
        fps = self.projected_all_packed(Ss, lam, basis)
        aux_iv = tuple(fp[0] for fp in fps)
        ll_aux = self.log_lik_all(obs, aux_state, inp_cur, aux_iv)
        return aux_state, aux_iv, ll_aux + log_weights, ll_aux, fps

    def resample(self, weights, u):
        """Sorted systematic ancestors ``(N,)`` int32 for weights ``(N,)``."""
        return self._systematic(weights, u, weights.shape[0])

    def draw_update_gather_all_packed(
        self, uvs, Ss, ancestors, lam, new_state, inp_cur,
    ):
        """Resampling gather + matrix-t draw + rank-1 statistics update per
        GP, the gather done inside the kernel. ``uvs`` holds each GP's
        ``(u, v)`` uniforms ``(n_i, N)``. Returns ``(Ss_new, new_iv,
        new_basis, lds)``."""
        new_basis = tuple(
            self.basis_all(i, new_state, inp_cur) for i in range(self.n_gp)
        )
        outs = tuple(
            self._draw_update_gather(
                Ss[i], ancestors, new_basis[i], uvs[i][0], uvs[i][1],
                self.jitter, lam, self.prior_blocks[i], p3=self.p3[i],
                m=self.ms[i], n=self.ns[i],
            )
            for i in range(self.n_gp)
        )
        Ss_new = tuple(o[0] for o in outs)
        new_iv = tuple(o[1] for o in outs)
        lds = tuple((o[2], o[3]) for o in outs)
        return Ss_new, new_iv, new_basis, lds

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
